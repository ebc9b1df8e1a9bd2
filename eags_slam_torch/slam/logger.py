"""Run logging (port of eags_slam_tpu.slam.logger): console + JSONL
structured logs; matplotlib panels and wandb uploads are optional and
verbose/flag-gated."""
from __future__ import annotations

import json
import os
import time
from typing import Dict


def _np(x):
    import numpy as np

    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class Logger:
    def __init__(self, output_path: str, verbose: bool = False,
                 use_wandb: bool = False):
        self.output_path = output_path
        self.verbose = verbose
        self.use_wandb = use_wandb
        self._wandb = None
        if use_wandb:
            try:  # pragma: no cover - network-gated
                import wandb

                self._wandb = wandb
            except ImportError:
                self.use_wandb = False
        os.makedirs(output_path, exist_ok=True)
        self._jsonl = open(os.path.join(output_path, "log.jsonl"), "a")

    def log(self, kind: str, payload: Dict):
        rec = {"t": time.time(), "kind": kind, **payload}
        self._jsonl.write(json.dumps(rec, default=float) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log({f"{kind}/{k}": v for k, v in payload.items()
                             if isinstance(v, (int, float))})
        if self.verbose:
            print(f"[{kind}] " + ", ".join(f"{k}={v}" for k, v in payload.items()))

    def log_tracking(self, frame_id: int, stats: Dict):
        """Per-frame tracking summary (reference log_tracking_iteration)."""
        self.log("tracking", {"frame": frame_id, **stats})

    def log_mapping(self, frame_id: int, stats: Dict):
        self.log("mapping", {"frame": frame_id, **stats})

    def vis_mapping(self, frame_id: int, rendered_color, rendered_depth,
                    gt_color, gt_depth, seeding_mask=None):
        """2x3 render-vs-GT panel saved to mapping_vis/ (reference
        vis_mapping_iteration, logger.py:116-199). Verbose-gated."""
        if not self.verbose:
            return
        try:  # pragma: no cover - visualization only
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            import numpy as np

            fig, ax = plt.subplots(2, 3, figsize=(12, 6))
            ax[0, 0].imshow(np.clip(_np(gt_color), 0, 1))
            ax[0, 0].set_title("GT color")
            ax[0, 1].imshow(_np(gt_depth), cmap="jet")
            ax[0, 1].set_title("GT depth")
            if seeding_mask is not None:
                ax[0, 2].imshow(_np(seeding_mask), cmap="gray")
                ax[0, 2].set_title("seeding mask")
            ax[1, 0].imshow(np.clip(_np(rendered_color), 0, 1))
            ax[1, 0].set_title("render")
            ax[1, 1].imshow(_np(rendered_depth), cmap="jet")
            ax[1, 1].set_title("render depth")
            resid = np.abs(
                _np(gt_color) - np.clip(_np(rendered_color), 0, 1)
            ).mean(-1)
            ax[1, 2].imshow(resid, cmap="jet")
            ax[1, 2].set_title("|residual|")
            for a in ax.flat:
                a.axis("off")
            d = os.path.join(self.output_path, "mapping_vis")
            os.makedirs(d, exist_ok=True)
            fig.savefig(os.path.join(d, f"{frame_id:05d}.png"), dpi=80)
            plt.close(fig)
        except Exception:
            pass

    def close(self):
        self._jsonl.close()
