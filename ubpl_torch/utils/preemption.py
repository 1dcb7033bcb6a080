"""Preemption handling: the port's copy of ``ubpl_tpu/utils/preemption.py``
(the reference has none).

Shared machines preempt; a SIGTERM/SIGINT sets a flag that the trainer
checks at epoch boundaries to checkpoint and exit cleanly, resumable via
BaseTrainer.resume / run(resume=True).
"""
import signal


class PreemptionGuard:
    _installed = None

    def __init__(self):
        self.requested = False
        self._prev = {}

    def install(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:  # non-main thread
                pass
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}

    @classmethod
    def get(cls):
        if cls._installed is None:
            cls._installed = cls().install()
        return cls._installed
