"""Leveled experiment logger: the port's copy of
``ubpl_tpu/utils/logger.py`` (reference utils/base/log.py:17-72).

Three severity levels L1 > L2 > L3; each level has its own file and higher
levels are included in lower files (thresholds 100/90/80).  The console
prints at a configurable level.  Elapsed-interval formatting follows the
reference's ``start=`` convention.  ``console_level=None`` prints nothing
(with no ``base_path``: a logger that writes nowhere).
"""
import datetime
import os

_LEVELS = {"L1": 100, "L2": 90, "L3": 80}


class Logger:
    def __init__(self, experiment, base_path=None, console_level="L1"):
        self.experiment = experiment
        self.console_threshold = (_LEVELS[console_level] if console_level
                                  else float("inf"))
        self.base_path = base_path
        self.files = {}
        if base_path:
            log_dir = os.path.join(base_path, "logs")
            os.makedirs(log_dir, exist_ok=True)
            for lvl in _LEVELS:
                self.files[lvl] = os.path.join(log_dir, f"log_{lvl}.log")

    def print(self, level, content, start=None):
        line = self._format(level, content, start)
        if _LEVELS[level] >= self.console_threshold:
            print(line, flush=True)
        for lvl, thr in _LEVELS.items():
            if _LEVELS[level] >= thr and lvl in self.files:
                with open(self.files[lvl], "a") as f:
                    f.write(line + "\n")

    def _format(self, level, content, start):
        now = datetime.datetime.now()
        stamp = now.strftime("%Y-%m-%d %H:%M:%S")
        if start is not None:
            interval = self._interval_format(
                seconds=(now - start).total_seconds())
            return f"[{stamp} {level}] {content} ({interval})"
        return f"[{stamp} {level}] {content}"

    @staticmethod
    def _interval_format(seconds):
        seconds = int(seconds)
        h, rem = divmod(seconds, 3600)
        m, s = divmod(rem, 60)
        return f"{h:02d}:{m:02d}:{s:02d}"
