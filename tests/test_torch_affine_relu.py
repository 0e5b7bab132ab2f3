"""The eval norm + ReLU op (``ogc_tpu_torch/ops/affine_relu.py``) on the CPU.

Its plain version is the eager chains FlowStep3D's eval conv stacks ran
before the op existed, ``F.relu(SchedulableBatchNorm(x))`` (the channel
form) and ``F.relu(g + t[:, :, None, :])`` (the rows form): bit-equal to
them in float32 and bfloat16, on rows holding NaN, +-0.0 and +-inf.  The
model's dispatch: an eval BatchNorm with no gradient needed reaches the op
(on CPU tensors its plain version, no launch), train mode, InstanceNorm and
a gradient keep the chain, and a FlowStep3D eval forward reaches it the
derived number of times and gives the flows the chains gave, bit for bit.
The wrapper raises on a wrong shape, dtype, layout or device (meta tensors
stand in for a device that is not the CPU).  SchedulableBatchNorm keeps its
eval operands, and a conv stack its weights cast to bfloat16, between calls
while nothing they are made from changes, and makes them anew when
something does or a gradient needs them.  A model of the kernel's walk
(csrc/affine_relu.cu's grid and lane stride) visits every 16-byte chunk of
every row once.  chip_smoke.py holds the CUDA kernel to the plain version on
the card.

torch must not share a process with JAX (tests/conftest.py imports jax),
so the torch side runs once in a subprocess of this file
(``python -m tests.test_torch_affine_relu <out.json>``) and the tests read
its JSON."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DTYPES = ("float32", "bfloat16")
FORMS = ("channel", "rows")
DATA = ("random", "edges")
MODULES = ("sa_fold", "sa_grouped", "embedding")
MODES = ("eval", "train", "inorm", "grad")
# (name, the error's words): each a call the wrapper refuses.
REFUSED = [("both_forms", "give channel"), ("no_form", "give channel"),
           ("channel_shape", "operand"), ("rows_shape", "operand"),
           ("rows_x_3d", "want \\(B, M"), ("operand_dtype", "operand"),
           ("three_operands", "channel operands"),
           ("device_dtype", "dtype"), ("device_layout", "contiguous"),
           ("device_not_cuda", "CUDA device"),
           ("device_operand_on_cpu", "CUDA device")]
# Kept eval operands and bf16 weights: (case, the BatchNorm's kept from the
# last call, the conv weight's kept).
KEPT = [("again", True, True), ("copied_in", False, False),
        ("state_loaded", False, False), ("eps_set", False, True),
        ("grad_recorded", False, False), ("weights_frozen", True, True)]
# FlowStep3D eval forwards (arch, points, iterations, compute dtype).
FORWARDS = [("sapien", 64, 2, "float32"), ("sapien", 64, 2, "bfloat16"),
            ("kitti", 256, 2, "float32")]


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_affine_relu") / "out.json")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("OGC_EXACT_NEIGHBORS", None)
    env.pop("OGC_EVAL_FOLD", None)
    proc = subprocess.run([sys.executable, "-m",
                           "tests.test_torch_affine_relu", out], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
def test_plain_is_the_eager_chain_bit_for_bit(got, form, dtype, data):
    r = got["plain"][f"{form}/{dtype}/{data}"]
    assert r["bit_equal"], r
    assert r["launches"] == 0
    if data == "edges":
        # The rows hold every edge value, and some of them reach the output.
        assert r["nan_out"] > 0 and r["zero_out"] > 0, r


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("module", MODULES)
def test_dispatch(got, module, dtype, mode):
    """eval: every ReLU after a norm reaches the op (the stacks' layers 0
    and 1 of 3; the last folds into the pool), and the output is the
    chain's, bit for bit; train, InstanceNorm and a gradient: the chain
    alone.  No launch on CPU tensors."""
    r = got["dispatch"][f"{module}/{dtype}/{mode}"]
    assert r["launches"] == 0
    assert r["bit_equal"], r
    if mode != "eval":
        assert r["calls"] == {"channel": 0, "rows": 0}, r
        return
    if module == "sa_grouped" or (module == "embedding"
                                  and dtype == "float32"):
        want = {"channel": 2, "rows": 0}
    else:
        want = {"channel": 1, "rows": 1}
    assert r["calls"] == want, r
    if mode == "grad":
        assert r["grad_finite"], r


def _derived_calls(arch, iters, dtype):
    """The op's calls in one FlowStep3D eval forward: every stack of three
    layers calls it twice (layer 0's rows form and layer 1's channel form
    with the eval fold, the last layer pools), FlowEmbedding in float32
    twice in the channel form; the single-layer stacks (H0Net's second
    conv, the GRU gates) fold everything into the pool.  Before the
    refinement: both enc_loc stacks and every enc_glob and corr stack,
    flow0's regressor, H0Net's first; each refinement: enc_loc's two, the
    FlowEmbedding, both flow convs and both regressor stacks."""
    n_glob, n_corr = {"sapien": (2, 1), "ogcdr": (2, 1), "kitti": (3, 2)}[arch]
    before = 2 + n_glob + n_corr + 2
    each = 6
    rows = before + (iters - 1) * each
    channel = rows
    if dtype == "float32":
        channel += (iters - 1) * 2
    else:
        rows += iters - 1
        channel += iters - 1
    return {"channel": channel, "rows": rows}


@pytest.mark.parametrize("case", FORWARDS, ids=lambda c: "_".join(map(str, c)))
def test_flowstep3d_eval_forward(got, case):
    r = got["forward"]["/".join(map(str, case))]
    arch, _, iters, dtype = case
    assert r["calls"] == _derived_calls(arch, iters, dtype), r
    assert r["launches"] == 0
    assert r["bit_equal"] and r["finite"], r
    # A second forward after the statistics and the conv weights moved in
    # place, against one recording a gradient: what was kept is made anew.
    assert r["bit_equal_after_update"], r


@pytest.mark.parametrize("case,bn_kept,w_kept", KEPT,
                         ids=[c for c, _, _ in KEPT])
def test_eval_operands_kept(got, case, bn_kept, w_kept):
    """The BatchNorm's ``eval_affine`` and ``eval_operands`` (float32 and
    bfloat16) and a conv stack's bfloat16 weight (``_w_compute``): the
    same tensors as the last call's when nothing changed, else new ones;
    the values always those made afresh, bit for bit."""
    for name, r in got["kept"][case].items():
        assert r["same_objects"] == (w_kept if name == "weight"
                                     else bn_kept), (name, r)
        assert r["bit_equal"], (name, r)
        # With a gradient recorded, the affine and the bfloat16 casts carry
        # a graph; float32's weight and bias are the parameters themselves.
        assert r["graph"] == (case == "grad_recorded"
                              and name != "float32"), (name, r)


@pytest.mark.parametrize("name,words", REFUSED, ids=[n for n, _ in REFUSED])
def test_wrapper_refuses(got, name, words):
    import re

    r = got["refused"][name]
    assert r["type"] == "ValueError", r
    assert re.search(words, r["message"]), r


def _walk(rows, c, itemsize, sms, aligned=True):
    """csrc/affine_relu.cu's launch and walk: the (row, chunk) pairs each
    lane visits."""
    threads, per_sm = 256, 4
    v = 16 // itemsize if aligned and (c * itemsize) % 16 == 0 else 1
    unroll = 2 if v == 8 else 4
    chunks = c // v
    n = rows * chunks
    blocks = min(-(-n // (threads * unroll)), sms * per_sm)
    blocks = max(blocks, -(-chunks // threads))
    lanes = blocks * threads // chunks * chunks
    step = lanes // chunks
    seen = {}
    for lane in range(lanes):
        c0 = lane % chunks
        row = lane // chunks
        while row < rows:
            for u in range(unroll):
                ru = row + u * step
                if ru < rows:
                    key = (ru, c0)
                    seen[key] = seen.get(key, 0) + 1
            row += unroll * step
    return seen, chunks, blocks


@pytest.mark.parametrize("rows,c,itemsize,sms", [
    (4096, 32, 4, 132), (1000, 16, 4, 132), (777, 128, 2, 132),
    (64, 256, 4, 132), (3, 3, 4, 132), (5000, 67, 4, 2), (513, 24, 2, 1),
    (1, 1024, 1, 1), (3000, 128, 2, 132), (100, 8, 2, 132)])
def test_kernel_walk_visits_every_chunk_once(rows, c, itemsize, sms):
    seen, chunks, blocks = _walk(rows, c, itemsize, sms)
    assert blocks <= max(sms * 4, -(-chunks // 256))
    assert len(seen) == rows * chunks
    assert set(seen.values()) == {1}


# ---------------------------------------------------------------------------
# torch side (a subprocess of this file)
# ---------------------------------------------------------------------------


def _bits(a, b):
    """Same shape and dtype, NaN at the same places, every other value the
    same bits (so -0.0 and +0.0 differ)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = a.isnan(), b.isnan()
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return bool(torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(as_int[a.dtype]),
        b.masked_fill(nb, 0).view(as_int[b.dtype])))


def _edges(t, gen):
    """t with NaN, +-0.0 and +-inf spread over its elements."""
    import torch

    flat = t.reshape(-1)
    vals = torch.tensor([float("nan"), 0.0, -0.0, float("inf"),
                         -float("inf")])
    pos = torch.randperm(flat.numel(), generator=gen)[:5 * 6]
    flat[pos] = vals.repeat(6).to(t.dtype)
    return t


def _plain():
    import torch
    import torch.nn.functional as F

    from ogc_tpu_torch.nn.flowstep3d import SchedulableBatchNorm
    from ogc_tpu_torch.ops.affine_relu import affine_relu, affine_relu_plain

    out = {}
    gen = torch.Generator().manual_seed(0)
    B, M, S, C = 2, 6, 8, 16
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        for data in DATA:
            x = torch.randn(B, M, S, C, generator=gen)
            bn = SchedulableBatchNorm(C).eval()
            with torch.no_grad():
                bn.weight.copy_(1 + 0.5 * torch.randn(C, generator=gen))
                bn.bias.copy_(0.5 * torch.randn(C, generator=gen))
                bn.running_mean.copy_(0.5 * torch.randn(C, generator=gen))
                bn.running_var.copy_(1 + torch.rand(C, generator=gen))
                t = torch.randn(B, M, C, generator=gen)
                if data == "edges":
                    x, t = _edges(x, gen), _edges(t, gen)
                    bn.weight[:3] = torch.tensor([0.0, -0.0, float("inf")])
                    bn.bias[3:6] = torch.tensor([0.0, -0.0, -float("inf")])
                    bn.running_mean[6:9] = torch.tensor(
                        [-0.0, float("inf"), float("nan")])
                    bn.running_var[9] = -bn.eps  # rsqrt(0) = inf
                x = x.to(dt)
                t = t.to(dt)
                cases = {
                    "channel": (affine_relu_plain(
                        x, channel=bn.eval_operands(dt)), F.relu(bn(x))),
                    "rows": (affine_relu_plain(x, rows=t),
                             F.relu(x + t[:, :, None, :]))}
                before = affine_relu.launches
                for form, (mine, chain) in cases.items():
                    y = affine_relu(x, **({"channel": bn.eval_operands(dt)}
                                          if form == "channel"
                                          else {"rows": t}), inplace=True)
                    out[f"{form}/{dtype}/{data}"] = {
                        "bit_equal": _bits(mine, chain) and _bits(y, chain),
                        "nan_out": int(chain.isnan().sum()),
                        "zero_out": int((chain == 0).sum()),
                        "launches": affine_relu.launches - before}
    return out


class _Spy:
    """Counts the model's calls of ops.affine_relu by form."""

    def __init__(self, ops):
        self.ops, self.fn = ops, ops.affine_relu
        self.calls = {"channel": 0, "rows": 0}

    def __enter__(self):
        def spy(x, channel=None, rows=None, inplace=False):
            self.calls["channel" if channel is not None else "rows"] += 1
            return self.fn(x, channel=channel, rows=rows, inplace=inplace)

        self.ops.affine_relu = spy
        return self

    def __exit__(self, *exc):
        self.ops.affine_relu = self.fn


class _Chains:
    """The model's ReLU sites as they were before the op: the eager
    chains."""

    def __enter__(self):
        import torch.nn.functional as F

        from ogc_tpu_torch.nn.flowstep3d import _ConvStack

        self.saved = (_ConvStack._norm_relu, _ConvStack.__dict__["_add_relu"])
        _ConvStack._norm_relu = lambda s, x, j: F.relu(s.mlp_bns[j](x))
        _ConvStack._add_relu = staticmethod(
            lambda g, t: F.relu(g + t[:, :, None, :]))
        return self

    def __exit__(self, *exc):
        from ogc_tpu_torch.nn.flowstep3d import _ConvStack

        _ConvStack._norm_relu, _ConvStack._add_relu = self.saved


def _perturb(model, gen):
    """BatchNorm affines and statistics away from the identity."""
    import torch

    from ogc_tpu_torch.nn.flowstep3d import InstanceNorm, SchedulableBatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (SchedulableBatchNorm, InstanceNorm)):
                n = m.weight.shape
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
            if isinstance(m, SchedulableBatchNorm):
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(1 + 0.2 * torch.rand(n, generator=gen))
                m.momentum = 0.1


def _dispatch():
    import torch

    from ogc_tpu_torch import ops
    from ogc_tpu_torch.nn import layers
    from ogc_tpu_torch.nn.flowstep3d import FlowEmbedding, FlowSAModule
    from ogc_tpu_torch.ops.affine_relu import affine_relu

    out = {}
    gen = torch.Generator().manual_seed(1)
    B, N = 2, 64
    pos1 = torch.rand(B, N, 3, generator=gen)
    pos2 = pos1 + 0.05 * torch.randn(B, N, 3, generator=gen)
    f1 = torch.randn(B, N, 8, generator=gen)
    f2 = torch.randn(B, N, 8, generator=gen)
    for module in MODULES:
        for dtype in DTYPES:
            layers.set_compute_dtype(None if dtype == "float32"
                                    else torch.bfloat16)
            for mode in MODES:
                inorm = mode == "inorm"
                if module == "embedding":
                    m = FlowEmbedding(0.5, 8, (16, 16, 16), 16,
                                      use_instance_norm=inorm)

                    def run(m=m):
                        return m(pos1, pos2, f1, f2)[1]
                else:
                    m = FlowSAModule(32, 8, (16, 16, 16), 8,
                                     use_instance_norm=inorm)

                    def run(m=m):
                        return m(pos1, f1)[1]
                _perturb(m, gen)
                m.train(mode == "train")
                os.environ["OGC_EVAL_FOLD"] = ("off" if module == "sa_grouped"
                                               else "on")
                grad = torch.enable_grad() if mode in ("grad", "train") \
                    else torch.no_grad()
                state = {k: v.clone() for k, v in m.state_dict().items()}
                before = affine_relu.launches
                with grad, _Spy(ops) as spy:
                    y = run()
                r = {"calls": spy.calls,
                     "launches": affine_relu.launches - before}
                if mode == "grad":
                    y.float().sum().backward()
                    r["grad_finite"] = all(
                        p.grad is not None and bool(p.grad.isfinite().all())
                        for p in m.mlp_convs.parameters())
                m.load_state_dict(state)
                with grad, _Chains():
                    r["bit_equal"] = _bits(y.detach(), run().detach())
                out[f"{module}/{dtype}/{mode}"] = r
    os.environ.pop("OGC_EVAL_FOLD")
    layers.set_compute_dtype(None)
    return out


def _forward():
    import torch

    from ogc_tpu_torch import ops
    from ogc_tpu_torch.models.flownet import FlowStep3D
    from ogc_tpu_torch.nn import layers
    from ogc_tpu_torch.ops.affine_relu import affine_relu

    out = {}
    for arch, n, iters, dtype in FORWARDS:
        gen = torch.Generator().manual_seed(2)
        layers.set_compute_dtype(None if dtype == "float32"
                                 else torch.bfloat16)
        model = FlowStep3D(npoint=n, arch=arch, loc_flow_nn=8,
                           loc_flow_rad=0.3, k_decay_fact=0.5, generator=gen)
        _perturb(model, gen)
        model.eval()
        pc1 = torch.rand(2, n, 3, generator=gen)
        pc2 = pc1 + 0.02 * torch.randn(2, n, 3, generator=gen)
        before = affine_relu.launches
        with torch.no_grad(), _Spy(ops) as spy:
            flows = model(pc1, pc2, pc1, pc2, iters)
        with torch.no_grad(), _Chains():
            want = model(pc1, pc2, pc1, pc2, iters)
        _perturb(model, gen)
        with torch.no_grad():
            for conv in model.modules():
                if isinstance(conv, torch.nn.Conv2d):
                    conv.weight.mul_(1 + 0.1 * torch.randn(
                        conv.weight.shape, generator=gen))
            again = model(pc1, pc2, pc1, pc2, iters)
        # With a gradient recorded nothing is kept and the chains run.
        with torch.enable_grad():
            want_again = [f.detach() for f in model(pc1, pc2, pc1, pc2,
                                                    iters)]
        out[f"{arch}/{n}/{iters}/{dtype}"] = {
            "calls": spy.calls,
            "bit_equal": all(_bits(a, b) for a, b in zip(flows, want)),
            "bit_equal_after_update": all(
                _bits(a, b) for a, b in zip(again, want_again)),
            "finite": all(bool(f.isfinite().all()) for f in flows),
            "launches": affine_relu.launches - before}
    layers.set_compute_dtype(None)
    return out


def _kept():
    """For each KEPT case: a conv stack's BatchNorm operands and bfloat16
    weight before and after the case's step, whether they are the same
    tensors, whether they equal those made afresh, and whether they carry
    an autograd graph."""
    import torch

    from ogc_tpu_torch.nn import layers
    from ogc_tpu_torch.nn.flowstep3d import _ConvStack, _operands

    gen = torch.Generator().manual_seed(3)
    C = 16

    def fresh_stack():
        stack = _ConvStack(8, (C, C)).eval()
        bn = stack.mlp_bns[0]
        with torch.no_grad():
            bn.weight.copy_(1 + 0.5 * torch.randn(C, generator=gen))
            bn.bias.copy_(0.5 * torch.randn(C, generator=gen))
            bn.running_mean.copy_(0.5 * torch.randn(C, generator=gen))
            bn.running_var.copy_(1 + torch.rand(C, generator=gen))
        return stack

    def operands(stack):
        bn = stack.mlp_bns[0]
        layers.set_compute_dtype(torch.bfloat16)
        try:
            w = stack._w_compute(0)
        finally:
            layers.set_compute_dtype(None)
        return {"affine": bn.eval_affine(),
                "float32": bn.eval_operands(torch.float32),
                "bfloat16": bn.eval_operands(torch.bfloat16),
                "weight": (w,)}

    def made_afresh(stack):
        bn = stack.mlp_bns[0]
        k = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        args = (bn.running_mean, bn.running_var, bn.eps, bn.weight, bn.bias)
        return {"affine": (k, bn.bias - bn.running_mean * k),
                "float32": _operands(torch.float32, *args),
                "bfloat16": _operands(torch.bfloat16, *args),
                "weight": (stack._w(0).to(torch.bfloat16),)}

    def step(case, stack):
        bn = stack.mlp_bns[0]
        if case == "copied_in":
            bn.running_var.copy_(bn.running_var * 2)
            stack.mlp_convs[0].weight.mul_(2)
        elif case == "state_loaded":
            state = {k: v + 1 if v.is_floating_point() else v
                     for k, v in stack.state_dict().items()}
            stack.load_state_dict(state)
        elif case == "eps_set":
            bn.eps = 1e-3
        elif case == "weights_frozen":
            stack.requires_grad_(False)

    out = {}
    for case, _, _ in KEPT:
        stack = fresh_stack()
        with torch.no_grad():
            first = operands(stack)
            step(case, stack)
        grad = torch.enable_grad() if case in ("grad_recorded",
                                               "weights_frozen") \
            else torch.no_grad()
        with grad:
            second = operands(stack)
        with torch.no_grad():
            want = made_afresh(stack)
        out[case] = {name: {
            "same_objects": all(a is b for a, b in zip(first[name],
                                                       second[name])),
            "bit_equal": all(_bits(a.detach(), b) for a, b in
                             zip(second[name], want[name])),
            "graph": any(t.grad_fn is not None for t in second[name])}
            for name in first}
    return out


def _refused():
    import torch

    from ogc_tpu_torch.ops.affine_relu import affine_relu

    C = 16
    x = torch.randn(2, 3, 4, C)
    ch = tuple(torch.randn(C) for _ in range(4))
    t = torch.randn(2, 3, C)
    meta = x.to("meta")
    meta_ch = tuple(o.to("meta") for o in ch)
    calls = {
        "both_forms": lambda: affine_relu(x, channel=ch, rows=t),
        "no_form": lambda: affine_relu(x),
        "channel_shape": lambda: affine_relu(
            x, channel=ch[:3] + (torch.randn(C + 1),)),
        "rows_shape": lambda: affine_relu(x, rows=torch.randn(2, 4, C)),
        "rows_x_3d": lambda: affine_relu(x[0], rows=t[0]),
        "operand_dtype": lambda: affine_relu(
            x, channel=ch[:3] + (ch[3].double(),)),
        "three_operands": lambda: affine_relu(x, channel=ch[:3]),
        "device_dtype": lambda: affine_relu(
            meta.double(), channel=tuple(o.double() for o in meta_ch)),
        "device_layout": lambda: affine_relu(meta.transpose(1, 2),
                                             channel=meta_ch),
        "device_not_cuda": lambda: affine_relu(meta, channel=meta_ch),
        "device_operand_on_cpu": lambda: affine_relu(meta, channel=ch),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = {"type": None, "message": ""}
        except Exception as e:  # the test reads the type
            out[name] = {"type": type(e).__name__, "message": str(e)}
    return out


def main(path: str) -> None:
    got = {"plain": _plain(), "dispatch": _dispatch(), "forward": _forward(),
           "refused": _refused(), "kept": _kept()}
    with open(path, "w") as f:
        json.dump(got, f)


if __name__ == "__main__":
    main(sys.argv[1])
