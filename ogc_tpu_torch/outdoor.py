"""The machinery the outdoor flow CLIs share (test_flow_kittisf,
test_flow_kittisf_benchmark, test_flow_waymo): their flags, the device side
on numpy arrays (``OutdoorFlow``: FPS, ICP, the ``kitti`` flownet and the
3-NN upsample), the padding of clouds to a shared length, and the flow
metrics.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ogc_tpu_torch import ops
from ogc_tpu_torch.metrics.flow import eval_flow
from ogc_tpu_torch.models.flownet import FlowStep3D
from ogc_tpu_torch.parallel import mesh
from ogc_tpu_torch.utils.checkpoint import load_model_state
from ogc_tpu_torch.utils.gpf import fps_downsample
from ogc_tpu_torch.utils.icp import icp_batched
from ogc_tpu_torch.utils.meters import AverageMeter

# ICP hyperparameters (reference test_flow_kittisf.py:69-72).
N_POINT_ICP, MAX_ICP_ITERS = 1024, 50
EPE_NORM_THRESH = 0.05
METRICS = ("EPE", "AccS", "AccR", "Outlier")


def pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Pad (m, 3) to (n, 3) with duplicates of row 0.  Duplicates are at
    min-distance 0 from the FPS seed (index 0), so FPS never selects them
    over a true point, and their higher indices lose every tie: batched
    FPS/KNN over padded clouds select exactly the per-scene indices."""
    if len(a) >= n:
        return a[:n]
    return np.concatenate(
        [a, np.broadcast_to(a[:1], (n - len(a), a.shape[1]))], 0)


def bucket(n: int, least: int = 0) -> int:
    """The padded length of a batch whose largest cloud has ``n`` points:
    a multiple of 4096, at least ``least``."""
    return max(-(-n // 4096) * 4096, least)


def check_flags(args) -> None:
    """The flag combinations the outdoor flow CLIs refuse."""
    if args.scene_batch > 1 and args.host_preproc:
        raise SystemExit("--scene_batch requires the batched on-device "
                         "preprocessing (drop --host_preproc)")


def flow_parser() -> argparse.ArgumentParser:
    """The flags shared by the outdoor flow CLIs."""
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str, help="Config file")
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--test_model_iters", type=int, default=4)
    parser.add_argument("--save", default=False, action="store_true")
    parser.add_argument("--approx_knn", default=False, action="store_true",
                        help="Approximate neighbour search (block-min, nested "
                             "FPS, frozen self-KNN)")
    parser.add_argument("--host_preproc", default=False, action="store_true",
                        help="Run the preprocessing with the host numpy "
                             "oracles")
    parser.add_argument("--dp", type=int, default=1,
                        help="With --scene_batch: shard the scene batch "
                             "over N local devices (0 = all)")
    parser.add_argument("--scene_batch", type=int, default=1,
                        help="Process K scenes per device dispatch")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the model runs on")
    return parser


class OutdoorFlow:
    """The device side of the outdoor flow CLIs on numpy arrays: FPS, ICP,
    the flownet (``kitti`` arch, k_decay_fact 0.5, the config's weights)
    and the 3-NN upsample, each batched over a leading axis.  With
    ``--scene_batch`` above 1 each call shards its batch over ``--dp``
    devices (``mesh.dp_eval_fwd``), as the JAX CLIs' batched paths do."""

    def __init__(self, args):
        ops.set_exact_neighbors(not args.approx_knn)
        # Full float32 matmuls (TF32 keeps ~3 digits).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(args.device)
        self.iters = args.test_model_iters
        fn = args.flownet
        self.n_point = fn["npoint"]
        self.net = FlowStep3D(
            npoint=fn["npoint"], arch="kitti",
            use_instance_norm=fn["use_instance_norm"],
            loc_flow_nn=fn["loc_flow_nn"], loc_flow_rad=fn["loc_flow_rad"],
            k_decay_fact=0.5)
        self.net.load_state_dict(load_model_state(args.save_path))
        self.net.to(self.device).eval()
        print("Loaded weights from", args.save_path)
        dp = getattr(args, "dp", 1) if getattr(args, "scene_batch", 1) > 1 \
            else 1
        self.devices = mesh.eval_devices(dp, args.device)
        self._flow = mesh.dp_eval_fwd(
            lambda net, p1, p2, full: ops.upsample_feat(
                full, p1, net(p1, p2, p1, p2, self.iters)[-1]),
            self.devices, self.net)

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device)

    def shard(self, fn, *arrays: np.ndarray):
        """``fn(None, *tensors)`` over the float32 ``arrays``, sharded over
        the devices."""
        return mesh.dp_eval_fwd(fn, self.devices)(
            *(np.asarray(a, np.float32) for a in arrays))

    def fps(self, P: np.ndarray, npoint: int) -> np.ndarray:
        """(K, N, 3) -> (K, npoint) FPS indices."""
        return self.shard(lambda _, p: ops.furthest_point_sample(p, npoint),
                          P)

    def icp(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        """(K, P, 3) x 2 -> (K, 4, 4) float32 transforms mapping A onto B."""
        return self.shard(lambda _, a, b: icp_batched(
            a, b, max_iterations=MAX_ICP_ITERS), A, B)

    def flow(self, pc1: np.ndarray, pc2: np.ndarray,
             pc1_full: np.ndarray) -> np.ndarray:
        """The network's flow on (K, npoint, 3) ``pc1``/``pc2``, upsampled
        by 3-NN onto (K, N, 3) ``pc1_full``."""
        return self._flow(*(np.asarray(a, np.float32)
                            for a in (pc1, pc2, pc1_full)))

    def subsample(self, pc: np.ndarray, npoint: int) -> np.ndarray:
        """One cloud's FPS subcloud."""
        return pc[fps_downsample(pc, npoint, self.device)]


def add_flow_metrics(meter: AverageMeter, gt: np.ndarray,
                     pred: np.ndarray) -> None:
    meter.append_loss(dict(zip(METRICS, eval_flow(
        gt[None], pred[None], epe_norm_thresh=EPE_NORM_THRESH))))
