"""The work counts of ``ogcbench/work/`` against what PyTorch counts: the
model FLOPs against ``torch.utils.flop_counter.FlopCounterMode`` over the
plain reference's forward at a small size, and the kernel functions'
operations and bytes on hand-sized inputs."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ogcbench import run, weights
from ogcbench.reference import flownet as ref_flownet
from ogcbench.reference import search as S
from ogcbench.reference import segnet as ref_segnet
from ogcbench.tests.tiny import tiny_spec
from ogcbench.work import _rules, fps, knn_exact, scatter_add_rows
from ogcbench.work.flowstep3d import forward_flops as flow_flops
from ogcbench.work.maskformer3d import forward_flops as seg_flops


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("exact", [True, False])
def test_maskformer3d_flops(exact):
    cfg = tiny_spec("seg_train.kittisf", n=1024)["cfg"]
    P = weights.make(ref_segnet.param_shapes(cfg), 0, "cpu")
    pc = torch.rand(2, 1024, 3) * 20
    got = counted(lambda: ref_segnet.forward(P, cfg, pc, S.Search(exact)))
    assert sum(f for f, _ in seg_flops(cfg, 2)) == got


@pytest.mark.parametrize("iters", [1, 3])
def test_flowstep3d_flops(iters):
    cfg = tiny_spec("flow_infer.kittisf", n=512)["cfg"]
    P = weights.make(ref_flownet.param_shapes(cfg), 0, "cpu")
    pc1, pc2 = torch.rand(2, 512, 3) * 20, torch.rand(2, 512, 3) * 20
    got = counted(lambda: ref_flownet.forward(P, cfg, pc1, pc2, iters,
                                              S.Search(True)))
    assert sum(f for f, _ in flow_flops(cfg, 2, iters)) == got


def test_flowstep3d_bf16_tags_keep_the_total():
    cfg = run.resolve("flow_infer.kittisf")["cfg"]
    f32 = flow_flops(cfg, 16, 4)
    bf16 = flow_flops(cfg, 16, 4, "bf16")
    assert sum(f for f, _ in f32) == sum(f for f, _ in bf16)
    assert {k for _, k in bf16} == {"f32", "bf16"}


def test_kernel_function_work():
    xyz = torch.rand(2, 100, 3)
    ops, nbytes, _ = fps.work((xyz, 10), {}, torch.zeros(2, 10,
                                                         dtype=torch.int32))
    assert ops == 9 * 2 * 100 * 9 and nbytes == 2 * 100 * 12 + 2 * 10 * 4
    g = torch.rand(2, 50, 4)
    idx = torch.zeros(2, 50, dtype=torch.int32)
    out = torch.zeros(2, 7, 4)
    ops, nbytes, _ = scatter_add_rows.work((idx, g, 7), {}, out)
    assert ops == 400 and nbytes == 400 * 4 + 100 * 4 + 56 * 4


def test_box_pairs_counts_the_cube():
    # a 1-D lattice: with half-width 1.0 each inner point sees 3 points
    p = torch.zeros(1, 16, 3)
    p[0, :, 0] = torch.arange(16.0) * 1.0
    half = torch.full((1, 16), 1.0)
    assert _rules.box_pairs(p, p, half) == 3 * 16 - 2
    # each point's 3rd neighbour (itself included) lies 1 away, 2 at the
    # ends: every cube holds 3 points
    d, i = S.knn_exact(p, p, 3)
    ops, _, _ = knn_exact.work((p, p, 3), {}, (d, i))
    assert ops == _rules.D2_OPS * 3 * 16


def test_a_kernel_symbol_added_as_data(tmp_path, monkeypatch):
    """A later kernel of a function adds its symbol as a text file."""
    import os.path as osp
    import shutil

    from ogcbench import trace

    here = osp.dirname(trace.__file__)
    copy = tmp_path / "ogcbench"
    shutil.copytree(here, copy, ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "work" / "fps-fps_v2.txt").write_text("fps_v2_kernel\n")
    monkeypatch.setattr(trace, "__file__", str(copy / "trace.py"))
    kernels = {m.__name__: k for m, k in trace.work_modules()}
    assert kernels["ogcbench.work.fps"] == ("fps_kernel", "fps_v2_kernel")
