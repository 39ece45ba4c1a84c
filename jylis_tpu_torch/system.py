"""System wrapper: wires the SYSTEM repo into the logger's dual sink.

The port's copy of jylis_tpu/system.py, whole.

Reference analog: system.pony:5-41 — every log line is prefixed with this
node's address and appended to the SYSTEM TLog with wall-clock millis, then
trimmed to config.system_log_trim; the same repo serves SYSTEM GETLOG and
rides the anti-entropy path, so `SYSTEM GETLOG` shows the merged recent log
of the whole cluster.
"""

from __future__ import annotations

from .models.repo_system import RepoSYSTEM
from .utils.config import Config


class System:
    def __init__(self, config: Config):
        self.config = config
        self.repo = RepoSYSTEM(config.addr.hash64())
        config.log.set_sys(self.log)

    def log(self, line: str) -> None:
        self.repo.inslog(f"{self.config.addr} {line}")
        self.repo.trimlog(self.config.system_log_trim)
