"""Host-side data layer of the port (counterpart of ``ubpl_tpu/data``):
datasources and splits (``base``, ``sources``), image IO (``native_io``),
materialisation (``arrays``), batch samplers (``sampler``), occluders and
the dataset preview."""
