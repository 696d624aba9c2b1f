"""Loss-spike capture: record spiking iterations + the samples that caused them.

A copy of ``dlrover_tpu/observability/loss_spike.py`` (numpy only): when
a step's loss exceeds a threshold past a warmup iteration, append
``iter, loss, sample-ids`` to a dated file so the bad samples can be
decoded and inspected offline; a rolling z-score mode on top of the
absolute threshold keeps a slowly decaying loss from needing manual
retuning. Detected spikes go onto the port's telemetry hub as
``NumericEvent``s.
"""

import os
import time
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np


def format_culprits(
    sample_ids: Optional[Sequence[int]] = None,
    per_sample_losses=None,
    top_k: int = 8,
) -> str:
    """``id:loss`` pairs for the worst offending samples (reference:
    TokenLossSpike's sample decoding), or the raw ids when no per-sample
    losses are available. Shared by the dated-file record and the
    NumericEvent detail the detector publishes."""
    if per_sample_losses is not None:
        ps = np.asarray(per_sample_losses).reshape(-1)
        order = np.argsort(-ps)[: min(top_k, ps.size)]
        ids = (
            [int(sample_ids[i]) for i in order]
            if sample_ids is not None
            else [int(i) for i in order]
        )
        return ",".join(
            f"{i}:{ps_i:.4f}" for i, ps_i in zip(ids, ps[order])
        )
    if sample_ids is not None:
        return ",".join(str(int(i)) for i in sample_ids)
    return ""


class LossSpikeDetector:
    """Detect + persist loss spikes.

    Args:
        save_dir: where spike records are appended (one file per day,
            reference layout). ``None`` disables persistence.
        min_iter: ignore the first N iterations (warmup noise).
        min_loss: absolute floor — a loss below this is never a spike.
        zscore: if set (and the window is warm), a loss above the floor
            must ALSO exceed ``mean + zscore * std`` of the trailing
            window, so a run that merely plateaus above the floor does
            not flag every step.
        window: trailing window length for the rolling statistics.
        publish_events: publish every detected spike onto the telemetry
            hub as a ``NumericEvent(kind="loss_spike")`` carrying the
            offending sample ids in ``detail``. Off for auxiliary
            detectors (e.g. the watchdog's internal one) so a spike is
            published exactly once per run.
    """

    def __init__(
        self,
        save_dir: Optional[str] = None,
        min_iter: int = 100,
        min_loss: float = 4.0,
        zscore: Optional[float] = 4.0,
        window: int = 200,
        publish_events: bool = True,
    ):
        self.save_dir = save_dir
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
        self.min_iter = min_iter
        self.min_loss = min_loss
        self.zscore = zscore
        self.publish_events = publish_events
        self._window: Deque[float] = deque(maxlen=window)
        self.spikes: List[Tuple[int, float]] = []

    def _is_spike(self, it: int, loss: float) -> bool:
        if it < self.min_iter or loss < self.min_loss:
            return False
        # past the floor, the z-score gate separates a genuinely high
        # plateau from a spike above it; it needs a warm baseline, so no
        # spikes are declared until the window has filled enough
        if self.zscore is not None:
            if len(self._window) < 20:
                return False
            xs = np.asarray(self._window)
            mu, sd = float(xs.mean()), float(xs.std())
            return sd > 0 and loss > mu + self.zscore * sd
        return True

    def update(
        self,
        it: int,
        loss,
        sample_ids: Optional[Sequence[int]] = None,
        per_sample_losses=None,
    ) -> bool:
        """Record one step; returns True when the step is a spike.

        ``per_sample_losses`` (e.g. per-sequence CE from the loss fn)
        narrows the record to the worst offenders, mirroring the
        reference's sample decoding path.
        """
        loss = float(loss)
        spike = self._is_spike(it, loss)
        if not spike:
            # spikes are kept out of the rolling baseline so one outlier
            # does not inflate the std and mask the next one
            self._window.append(loss)
            return False
        self.spikes.append((it, loss))
        culprits = format_culprits(sample_ids, per_sample_losses)
        if self.publish_events:
            from dlrover_tpu_torch.observability import telemetry

            hub = telemetry.get_hub()
            if hub.enabled:
                hub.publish(
                    telemetry.NumericEvent(
                        kind="loss_spike",
                        step=it,
                        value=loss,
                        detail=culprits,
                    )
                )
        if self.save_dir:
            fname = os.path.join(
                self.save_dir,
                time.strftime("loss_spike_%Y%m%d.txt"),
            )
            with open(fname, "a") as f:
                f.write(f"{int(time.time())}\t{it}\t{loss:.6f}\t{culprits}\n")
        return True

    def update_block(
        self,
        first_it: int,
        losses,
        sample_ids: Optional[Sequence[Sequence[int]]] = None,
        per_sample_losses: Optional[Sequence] = None,
    ) -> List[int]:
        """Ingest a fused block's stacked per-step loss vector.

        ``losses[i]`` is the loss of global step ``first_it + i`` (the
        [K] array a K-step ``train_block`` returns).  Steps run through
        the SAME rolling baseline in order, so detection fires at the
        exact offending step — a spike at position i inside a block is
        recorded as iteration ``first_it + i``, not at the block
        boundary.  ``sample_ids``/``per_sample_losses``, when given, are
        per-step sequences aligned with ``losses``.  Returns the
        spiking iterations.
        """
        spiked: List[int] = []
        for i, loss in enumerate(np.asarray(losses).reshape(-1)):
            it = first_it + i
            if self.update(
                it,
                loss,
                sample_ids=sample_ids[i] if sample_ids is not None else None,
                per_sample_losses=per_sample_losses[i]
                if per_sample_losses is not None
                else None,
            ):
                spiked.append(it)
        return spiked

    @staticmethod
    def decode(path: str, min_loss: float = 0.0):
        """Read back spike records: [(ts, iter, loss, culprit_str), ...]."""
        out = []
        with open(path) as f:
            for line in f:
                ts, it, loss, culprits = (line.rstrip("\n").split("\t") + [""])[
                    :4
                ]
                if float(loss) >= min_loss:
                    out.append((int(ts), int(it), float(loss), culprits))
        return out
