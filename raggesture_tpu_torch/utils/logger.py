"""Logging and metric writers.  Port of ``raggesture_tpu/utils/logger.py``
(``get_root_logger``, ``NullWriter``, ``MetricWriter``, ``collect_env``),
after the reference's TextLoggerHook and TensorboardLoggerHook
(basegesture_len150_beat.py:19-21): the process-wide "raggesture" logger,
and scalars fanned out to the text log, ``metrics.jsonl`` and TensorBoard
when ``torch.utils.tensorboard`` imports."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

_LOGGER_NAME = "raggesture"
_LOG_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_root_logger(log_file: Optional[str] = None,
                    log_level: int = logging.INFO) -> logging.Logger:
    """The "raggesture" logger: one stream handler, added at the first
    call, and a file handler per distinct ``log_file``."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not any(getattr(h, "_raggesture", False) for h in logger.handlers):
        logger.setLevel(log_level)
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(_LOG_FORMAT))
        sh._raggesture = True
        logger.addHandler(sh)
        logger.propagate = False
    if log_file is not None and not any(
        isinstance(h, logging.FileHandler)
        and getattr(h, "baseFilename", None) == os.path.abspath(log_file)
        for h in logger.handlers
    ):
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_LOG_FORMAT))
        logger.addHandler(fh)
    return logger


class NullWriter:
    """A MetricWriter that writes nothing: the data-parallel ranks other
    than 0, whose metrics are rank 0's (the logs are all-reduced)."""

    def write(self, *args, **kwargs):
        pass

    def close(self):
        pass


class MetricWriter:
    """Scalars to the text log (every ``interval`` steps, or when forced),
    to ``<workdir>/metrics.jsonl`` (one JSON object a call: the scalars,
    list-valued entries as lists, then ``step``, ``time``, ``prefix`` and
    ``epoch``) and to TensorBoard under ``<workdir>/tf_logs``."""

    def __init__(self, workdir: str, interval: int = 10,
                 tensorboard: bool = True):
        self.workdir = workdir
        self.interval = interval
        self.logger = get_root_logger()
        os.makedirs(workdir, exist_ok=True)
        self._jsonl = open(os.path.join(workdir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(workdir, "tf_logs"))
            except Exception as e:  # the tensorboard package is optional
                self.logger.warning("tensorboard unavailable: %s", e)

    def write(self, step: int, scalars: Dict[str, float],
              prefix: str = "train", epoch: Optional[int] = None,
              force: bool = False):
        # vectors (per-sample losses) go to the JSONL record as they are;
        # TensorBoard and the text line take the scalars
        vectors = {k: list(map(float, v)) for k, v in scalars.items()
                   if isinstance(v, (list, tuple))}
        scalars = {k: float(v) for k, v in scalars.items()
                   if not isinstance(v, (list, tuple))}
        # the record's own keys win over a metric of the same name
        rec = dict(scalars)
        rec.update(vectors)
        rec.update(step=step, time=time.time(), prefix=prefix)
        if epoch is not None:
            rec["epoch"] = epoch
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}/{k}", v, step)
        if force or step % self.interval == 0:
            parts = ", ".join(f"{k}: {v:.4g}" for k, v in scalars.items())
            at = f"epoch {epoch}, " if epoch is not None else ""
            self.logger.info("[%s] %sstep %d: %s", prefix, at, step, parts)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def collect_env() -> Dict[str, str]:
    """What the training tool logs at its start: Python, the platform,
    torch, its CUDA, the cards and nvcc's release where one is found."""
    import platform
    import shutil
    import subprocess

    import torch

    info = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "torch_cuda": str(torch.version.cuda),
        "cuda_available": str(torch.cuda.is_available()),
    }
    if torch.cuda.is_available():
        info["device_count"] = str(torch.cuda.device_count())
        info["devices"] = ", ".join(torch.cuda.get_device_name(i)
                                    for i in range(torch.cuda.device_count()))
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"  # ops/build.py's
    if os.path.exists(nvcc):
        try:
            out = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True, timeout=30).stdout
            info["nvcc"] = out.strip().splitlines()[-1] if out else "?"
        except (OSError, subprocess.SubprocessError) as e:
            info["nvcc"] = f"unavailable ({e})"
    return info
