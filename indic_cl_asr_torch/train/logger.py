"""Run logger: wandb (when importable) + text log + JSONL metrics.

Port of indic_cl_asr_tpu/train/logger.py (reference utils.py:7-53
`Logger`): every ``log(dict)`` is appended to ``<output_dir>/<run_id>/``
``log.txt`` and ``metrics.jsonl`` (tensors as floats) and sent to wandb
when a run could be started; plain numbers are accumulated and re-logged
as ``epoch_avg_*`` by ``log_epoch_average()``; ``log_bwt_curves`` writes
``bwt_curves.json``. Rank 0 of an initialised ``torch.distributed`` group
owns the canonical files and wandb and draws the run id, which it
broadcasts; other ranks write rank-suffixed streams into the same
directory.
"""

from __future__ import annotations

import json
import os
import time
import uuid

from ..parallel.distributed import broadcast_from_main, process_index


class Logger:
    def __init__(
        self,
        output_dir: str,
        run_id: str | None = None,
        use_wandb: bool = True,
        wandb_kwargs: dict | None = None,
    ):
        self.rank = process_index()
        # one run dir for the whole group: process 0's id, broadcast
        self.run_id = run_id or broadcast_from_main(uuid.uuid4().hex[:8])
        self.dir = os.path.join(output_dir, self.run_id)
        os.makedirs(self.dir, exist_ok=True)
        sfx = "" if self.rank == 0 else f".rank{self.rank}"
        self._txt = open(os.path.join(self.dir, f"log{sfx}.txt"), "a")
        self._jsonl = open(os.path.join(self.dir, f"metrics{sfx}.jsonl"), "a")
        self._epoch_acc: dict[str, list[float]] = {}
        self._wandb = None
        if use_wandb and self.rank == 0:
            try:
                import wandb

                self._wandb = wandb.init(dir=self.dir, **(wandb_kwargs or {}))
            except Exception:  # no wandb, or no network: text and JSONL only
                self._wandb = None

    def log(self, record: dict) -> None:
        stamped = {"_time": time.time(), **_to_plain(record)}
        line = json.dumps(stamped, ensure_ascii=False) + "\n"
        self._txt.write(line)
        self._txt.flush()
        self._jsonl.write(line)
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(_to_plain(record))
        for k, v in record.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._epoch_acc.setdefault(k, []).append(float(v))

    def log_epoch_average(self) -> dict:
        """Re-log accumulated numeric means as epoch_avg_* and reset
        (utils.py:34-53)."""
        avg = {f"epoch_avg_{k}": sum(v) / len(v) for k, v in self._epoch_acc.items() if v}
        self._epoch_acc.clear()
        if avg:
            self.log(avg)
        return avg

    def log_bwt_curves(self, curves: dict[str, list[tuple[int, float]]]) -> None:
        """Per-language BWT curves (reference utils.py:213-240): always
        written to <dir>/bwt_curves.json, and with a live wandb run also
        uploaded as a scatter and a line plot per language."""
        if self.rank != 0:
            return
        plain = {lang: [[int(t), float(b)] for t, b in pts] for lang, pts in curves.items()}
        with open(os.path.join(self.dir, "bwt_curves.json"), "w") as f:
            json.dump(plain, f, indent=2)
        if self._wandb is None:
            return
        import wandb

        for lang, points in curves.items():
            if not points:
                continue
            table = wandb.Table(columns=["Task Index", "BWT"],
                                data=[[t, b] for t, b in points])
            self._wandb.log({
                f"BWT/{lang}/scatter": wandb.plot.scatter(
                    table, "Task Index", "BWT", title=f"BWT vs Task Index ({lang})"),
                f"BWT/{lang}/line": wandb.plot.line_series(
                    xs=[t for t, _ in points], ys=[[b for _, b in points]], keys=[lang],
                    title=f"BWT curve ({lang})", xname="Task Index"),
            })

    def close(self) -> None:
        self._txt.close()
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()


def _to_plain(record: dict) -> dict:
    out = {}
    for k, v in record.items():
        try:
            out[k] = float(v) if hasattr(v, "item") else v
        except (TypeError, ValueError, RuntimeError):
            out[k] = str(v)
    return out
