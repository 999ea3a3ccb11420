"""Sequential streaming runner (counterpart of the ``chunk_size=1``,
``window_size=1`` path of ``dynaboa_tpu/engine/runner.py``): adapt on every
frame, record its outputs on the host right after its step, aggregate
MPJPE / PA-MPJPE / PVE, and write the same artifacts (``res.txt``,
``scalars.jsonl``, the npz records and, with ``save_predictions``,
``result/Pred_*.npz``)."""

from __future__ import annotations

import os
import os.path as osp
import time

import numpy as np
import torch

from dynaboa_tpu import constants
from dynaboa_tpu_torch.engine.bilevel import AdaptState, BilevelEngine, Frame
from dynaboa_tpu_torch.metrics.writer import ScalarWriter


def frame_from_item(item: dict, device, keypoint_source: str = "gt") -> Frame:
    """Lift a host-preprocessed dataset item (no batch dim) into a Frame on
    ``device``."""
    if "image" not in item:
        raise NotImplementedError(
            "raw-frame items (fused preprocessing) are not ported")
    j2d = item["op_j2d"] if keypoint_source == "openpose" else item["smpl_j2d"]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)[None]).to(device)

    return Frame(
        image=t(item["image"]), j2d=t(j2d), pose=t(item["pose"]),
        betas=t(item["betas"]),
        gender=torch.tensor([int(item["gender"])], dtype=torch.int32,
                            device=device),
        mask=torch.ones((1,), dtype=torch.float32, device=device))


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


class StreamRunner:
    def __init__(self, engine: BilevelEngine, exppath: str,
                 save_predictions: bool = False, log_every: int = 200):
        self.engine = engine
        self.exppath = exppath
        os.makedirs(osp.join(exppath, "result"), exist_ok=True)
        self.writer = ScalarWriter(exppath)
        self.save_predictions = save_predictions
        self.log_every = log_every
        self.mpjpe_all: list[float] = []
        self.pampjpe_all: list[float] = []
        self.pve_all: list[float] = []
        self.lower_mpjpe: dict[int, list[float]] = {}
        self.lower_pampjpe: dict[int, list[float]] = {}
        self.kp2d_lower: list[float] = []
        self.kp2d_upper: dict[int, float] = {}
        self.feat_sims: dict[int, list[float]] = {}
        self.step_sims: dict[int, np.ndarray] = {}
        self.step_losses: dict[int, np.ndarray] = {}
        self.step_stats: dict[int, tuple] = {}
        self.optim_step_record: list[int] = []
        self.step_times: list[float] = []
        self.frames_seen = 0

    def run(self, stream, init_state: AdaptState, keypoint_source: str = "gt",
            max_frames: int | None = None, chunk_size: int = 1,
            window_size: int = 1) -> tuple[AdaptState, dict]:
        """Adapt frame by frame.  Each frame's time runs from its upload to
        its outputs on the host, so it covers all device work of the step."""
        if chunk_size != 1 or window_size != 1:
            raise NotImplementedError(
                "chunked and windowed modes are not ported")
        state = init_state
        device = self.engine.device
        for i, item in enumerate(iter(stream)):
            if max_frames is not None and i >= max_frames:
                break
            t0 = time.perf_counter()
            frame = frame_from_item(item, device, keypoint_source)
            state, out = self.engine.step(state, frame)
            out = _to_host(out)
            self.step_times.append(time.perf_counter() - t0)
            self._record(i, out)
            if (i + 1) % self.log_every == 0 and self.mpjpe_all:
                print(f"Step:{i}: MPJPE:{np.mean(self.mpjpe_all):.2f}, "
                      f"PAMPJPE:{np.mean(self.pampjpe_all):.2f}, "
                      f"PVE:{np.mean(self.pve_all):.2f}, "
                      f"{1.0 / np.mean(self.step_times[-self.log_every:]):.2f}"
                      f" fps")
        summary = self.finalize(len(stream))
        summary["param_devices"] = sorted({str(p.device)
                                           for p in state.params.values()})
        return state, summary

    def _record(self, i: int, out: dict):
        scalars = {}
        self.frames_seen += 1
        if "mpjpe" in out:
            m = float(np.mean(out["mpjpe"]))
            pa = float(np.mean(out["pampjpe"]))
            pv = float(np.mean(out["pve"]))
            # non-finite frames reach the scalar log but not the aggregates
            if np.isfinite(m) and np.isfinite(pa) and np.isfinite(pv):
                self.mpjpe_all.append(m)
                self.pampjpe_all.append(pa)
                self.pve_all.append(pv)
            scalars.update({"metrics/mpjpe": m, "metrics/pampjpe": pa,
                            "metrics/pve": pv})
        for k, v in out.get("lower", {}).items():
            scalars[f"ll/{k}"] = float(np.mean(v))
        for k, v in out.get("upper", {}).items():
            if k.startswith("teacher_"):
                scalars[f"teacher/{k[len('teacher_'):]}"] = float(np.mean(v))
            else:
                scalars[f"ul/{k}"] = float(np.mean(v))
        if "s2dloss" in out.get("lower", {}):
            self.kp2d_lower.append(float(np.mean(out["lower"]["s2dloss"])))
        if "s2dloss" in out.get("upper", {}):
            self.kp2d_upper[i] = float(np.mean(out["upper"]["s2dloss"]))
        j = 0
        while f"lower_{j}_mpjpe" in out:
            self.lower_mpjpe.setdefault(j, []).append(
                float(np.mean(out[f"lower_{j}_mpjpe"])))
            self.lower_pampjpe.setdefault(j, []).append(
                float(np.mean(out[f"lower_{j}_pampjpe"])))
            scalars[f"metrics/lower_{j}_mpjpe"] = self.lower_mpjpe[j][-1]
            scalars[f"metrics/lower_{j}_pampjpe"] = self.lower_pampjpe[j][-1]
            j += 1
        if "optim_steps" in out:
            self.optim_step_record.append(int(out["optim_steps"]))
            scalars["dynamic/optim_steps"] = self.optim_step_record[-1]
        if "feat_sim" in out:
            sims = np.asarray(out["feat_sim"])
            self.feat_sims[i] = sims.tolist()
            scalars["feat_sim/cos_sim"] = float(sims.mean())
            scalars["feat_sim/tap12"] = float(sims[12])
        if "per_step_sims" in out:
            nupd = int(out["optim_steps"]) + 1
            self.step_sims[i] = np.asarray(out["per_step_sims"])[:nupd]
            self.step_losses[i] = np.asarray(out["per_step_loss"])[:nupd]
            if "per_step_mpjpe" in out:
                self.step_stats[i] = tuple(
                    np.asarray(out[k])[:nupd].mean(-1)
                    for k in ("per_step_mpjpe", "per_step_pampjpe",
                              "per_step_pve"))
        self.writer.write(i, scalars)

        if self.save_predictions:
            # 'cam' is the weak-perspective cam converted to a camera
            # translation; the raw crop-space cam rides along as 'cam_crop'
            cam = np.asarray(out["cam"])
            tz = (2.0 * constants.FOCAL_LENGTH
                  / (constants.IMG_RES * cam[:, 0] + 1e-9))
            cam_t = np.stack([cam[:, 1], cam[:, 2], tz], axis=-1)
            np.savez(osp.join(self.exppath, "result", f"Pred_{i}.npz"),
                     verts=out["verts"], cam=cam_t, cam_crop=cam,
                     rotmat=out["rotmat"], beta=out["beta"])

    @staticmethod
    def _padded_trajectories(traj: dict[int, np.ndarray], prefix: str):
        """Ragged per-frame trajectories -> NaN-padded matrix + counts."""
        if not traj:
            return {}
        keys = list(traj.keys())
        counts = np.array([len(traj[i]) for i in keys], np.int32)
        mat = np.full((len(keys), int(counts.max())), np.nan, np.float32)
        for r, i in enumerate(keys):
            mat[r, : counts[r]] = traj[i]
        return {f"{prefix}_steps": np.asarray(keys), f"{prefix}": mat,
                f"{prefix}_counts": counts}

    def finalize(self, n_total: int) -> dict:
        ex = self.exppath
        self.writer.flush()

        def mean(v):
            return float(np.mean(v)) if len(v) else float("nan")

        # the first frame carries the one-off costs (kernel build, cuDNN
        # and allocator warm-up); report steady state when there is more
        steady = self.step_times[1:] if len(self.step_times) > 1 \
            else self.step_times
        summary = {
            "mpjpe": mean(self.mpjpe_all),
            "pampjpe": mean(self.pampjpe_all),
            "pve": mean(self.pve_all),
            "frames": self.frames_seen,
            "frames_total": n_total,
            "fps": 1.0 / mean(steady) if steady else 0.0,
            "first_frame_s": self.step_times[0] if self.step_times else 0.0,
            "optim_steps": list(self.optim_step_record),
        }
        print("--- Final ---")
        print(f"MPJPE:{summary['mpjpe']}, PAMPJPE:{summary['pampjpe']}, "
              f"PVE:{summary['pve']}  ({summary['fps']:.2f} adapted fps)")

        np.savez(osp.join(ex, "res.npz"), mpjpe=self.mpjpe_all,
                 pampjpe=self.pampjpe_all, pve=self.pve_all)
        np.savez(osp.join(ex, "lower_res.npz"),
                 mpjpe=np.array([self.lower_mpjpe[k] for k in
                                 sorted(self.lower_mpjpe)], dtype=object),
                 pampjpe=np.array([self.lower_pampjpe[k] for k in
                                   sorted(self.lower_pampjpe)], dtype=object),
                 allow_pickle=True)
        np.savez(osp.join(ex, "lowerlevel_kp2dloss.npz"),
                 kp2dloss=self.kp2d_lower)
        np.savez(osp.join(ex, "upperlevel_kp2dloss.npz"),
                 steps=list(self.kp2d_upper.keys()),
                 kp2dloss=list(self.kp2d_upper.values()))
        if self.feat_sims:
            np.savez(osp.join(ex, "feat_sims.npz"),
                     steps=list(self.feat_sims.keys()),
                     sims=np.asarray(list(self.feat_sims.values())),
                     **self._padded_trajectories(self.step_sims, "per_step"))
        if self.step_stats:
            np.savez(
                osp.join(ex, "steps_statistic_res.npz"),
                **self._padded_trajectories(
                    {i: v[0] for i, v in self.step_stats.items()}, "mpjpe"),
                **self._padded_trajectories(
                    {i: v[1] for i, v in self.step_stats.items()}, "pampjpe"),
                **self._padded_trajectories(
                    {i: v[2] for i, v in self.step_stats.items()}, "pve"),
                **self._padded_trajectories(self.step_losses, "upper_loss"),
            )
        np.savez(osp.join(ex, "optim_step_record.npz"),
                 step=self.optim_step_record)
        with open(osp.join(ex, "res.txt"), "w") as f:
            f.write(f"MPJPE:{summary['mpjpe']}, "
                    f"PAMPJPE:{summary['pampjpe']}, PVE:{summary['pve']}\n")
            for k in sorted(self.lower_mpjpe):
                f.write(f"Lower-level Step:{k} "
                        f"MPJPE:{mean(self.lower_mpjpe[k])}, "
                        f"PAMPJPE:{mean(self.lower_pampjpe[k])}\n")
        return summary

    def close(self):
        self.writer.close()
