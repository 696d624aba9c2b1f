"""ParalConfigTuner: the master's runtime config → a local JSON document.

Port of ``dlrover_tpu/agent/config_tuner.py`` (reference:
dlrover/python/elastic_agent/config/paral_config_tuner.py:30): the agent
polls the master for its ``ParallelConfig`` and writes it where the
workers read it (``GraftEnv.PARAL_CONFIG_PATH``, which the tuner sets
for the processes the agent starts): ``elastic/dataloader.py``'s
``load_config`` reads the dataloader fields, the elastic example worker
the Brain's tuning directive.

The document carries two independently versioned payloads: the
dataloader config (``version``, ``batch_size``, ``num_workers``,
``grad_accum_steps``) and the Brain's latest tuning directive
(``tuning``: a ``cluster/brain.py`` TuningPlan as a plain dict, and
``tuning_version``, the master's version of it). The tuner writes when
the version pair changes, so a dataloader re-config and a tuning
revision never mask each other. A failing poll is logged once per
reason and backs off (jittered, exponential) on top of the period.
"""

import json
import os
import tempfile
import threading
from typing import Optional, Set, Tuple

from dlrover_tpu_torch.common.comm import _backoff_delay
from dlrover_tpu_torch.common.constants import GraftEnv
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


def default_config_path() -> str:
    """The document's path when ``GraftEnv.PARAL_CONFIG_PATH`` is unset:
    in the temporary directory, one a run id."""
    run_id = os.environ.get(GraftEnv.RUN_ID, "")
    name = (f"dlrover_tpu_paral_config_{run_id}.json" if run_id
            else "dlrover_tpu_paral_config.json")
    return os.path.join(tempfile.gettempdir(), name)


class ParalConfigTuner:
    def __init__(
        self,
        client,
        config_path: Optional[str] = None,
        interval_s: float = 30.0,
    ):
        self._client = client
        self.config_path = config_path or os.environ.get(
            GraftEnv.PARAL_CONFIG_PATH) or default_config_path()
        os.environ[GraftEnv.PARAL_CONFIG_PATH] = self.config_path
        self._interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_versions: Tuple[int, int] = (-1, -1)
        # warn once per reason + back off: a master down for an hour must
        # not log a traceback every period
        self._warned_reasons: Set[str] = set()
        self._fail_streak = 0

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="paral-config-tuner", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        while True:
            delay = self._interval_s
            if self._fail_streak:
                # consecutive failures: jittered exponential backoff on
                # top of the period, so a fleet of tuners does not hammer
                # a recovering master in lockstep
                delay += _backoff_delay(min(self._fail_streak, 6) - 1)
            if self._stop.wait(delay):
                return
            self.poll_once()

    def _note_failure(self, exc: BaseException) -> None:
        self._fail_streak += 1
        reason = f"{type(exc).__name__}: {exc}"
        if reason not in self._warned_reasons:
            self._warned_reasons.add(reason)
            logger.warning(
                "parallel config poll failed (%s); repeats of this "
                "reason logged at debug",
                reason,
                exc_info=True,
            )
        else:
            logger.debug(
                "parallel config poll failed again (%s), streak %d",
                reason,
                self._fail_streak,
            )

    def poll_once(self) -> bool:
        try:
            cfg = self._client.get_parallel_config()
        except Exception as e:  # noqa: BLE001
            self._note_failure(e)
            return False
        self._fail_streak = 0
        tuning_version = getattr(cfg, "tuning_version", 0)
        versions = (cfg.version, tuning_version)
        if versions == self._last_versions:
            return False
        self._last_versions = versions
        doc = {
            "version": cfg.version,
            "batch_size": cfg.batch_size,
            "num_workers": cfg.num_workers,
            "grad_accum_steps": cfg.grad_accum_steps,
        }
        tuning_json = getattr(cfg, "tuning_json", "")
        if tuning_json:
            try:
                doc["tuning"] = json.loads(tuning_json)
                doc["tuning_version"] = tuning_version
            except json.JSONDecodeError:
                logger.warning(
                    "dropping malformed tuning directive v%d",
                    tuning_version,
                )
        tmp = self.config_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.config_path)
        logger.info(
            "wrote parallel config v%d (tuning v%d)",
            cfg.version,
            tuning_version,
        )
        return True


def read_tuning(path: Optional[str] = None):
    """The tuning directive of the document at ``path`` (default: the
    agent's, ``GraftEnv.PARAL_CONFIG_PATH``): ``(tuning_version, the
    TuningPlan dict with that version)``, or ``(0, None)`` when there is
    none or the file is missing or torn."""
    path = path or os.environ.get(GraftEnv.PARAL_CONFIG_PATH, "")
    if not path:
        return 0, None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return 0, None
    version = int(doc.get("tuning_version", 0) or 0)
    plan = doc.get("tuning")
    if not version or not isinstance(plan, dict):
        return 0, None
    return version, dict(plan, version=version)
