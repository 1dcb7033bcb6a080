"""Host-side data helpers of the port (counterpart of ``ubpl_tpu/data``)."""
