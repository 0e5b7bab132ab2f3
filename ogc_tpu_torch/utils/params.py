"""Carry MaskFormer3D and FlowStep3D weights from the JAX package to the
port (numpy only).

``segnet_state_dict_from_jax`` is the inverse of
ogc_tpu/utils/torch_interop.py::segnet_params_from_torch: it maps a flax
parameter tree onto the reference state_dict key space, which the port's
``MaskFormer3D.load_state_dict`` takes after ``torch.from_numpy``.
``flownet_state_dict_from_jax`` is the inverse of
::flownet_variables_from_torch for FlowStep3D's params and batch_stats.
This module imports neither torch nor jax, so either process can use it.

Layouts translated:
  Dense kernel (C_in, C_out)          -> conv weight (C_out, C_in, 1[, 1])
  Dense kernel (in, out)              -> linear weight (out, in)
  GroupNorm/LayerNorm scale/bias      -> weight/bias
  query/key/value kernels (E, H, hd)  -> packed in_proj_weight (3E, E)
  out kernel (H, hd, E)               -> out_proj.weight (E, E)
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

State = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    """float32, or float64 for a float64 tree (the CPU tests' float64
    runs)."""
    a = np.asarray(x)
    return np.array(a, dtype=np.float64 if a.dtype == np.float64
                    else np.float32)


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _conv(kernel, conv_dims: int) -> np.ndarray:
    k = _a(kernel).T
    return k.reshape(k.shape + (1,) * conv_dims)


def _count(node: Mapping[str, Any], stem: str) -> int:
    n = 0
    while f"{stem}{n}" in node:
        n += 1
    return n


def shared_mlp_state(node: Mapping[str, Any], prefix: str = "") -> State:
    """flax SharedMLP (PointwiseConv_j: Dense_0 + GroupNorm_0) -> port
    SharedMLP (layer{j}.conv / layer{j}.normlayer.gn)."""
    out = {}
    for j in range(_count(node, "PointwiseConv_")):
        leaf = node[f"PointwiseConv_{j}"]
        lp = _key(prefix, f"layer{j}")
        out[f"{lp}.conv.weight"] = _conv(leaf["Dense_0"]["kernel"], 2)
        out[f"{lp}.normlayer.gn.weight"] = _a(leaf["GroupNorm_0"]["scale"])
        out[f"{lp}.normlayer.gn.bias"] = _a(leaf["GroupNorm_0"]["bias"])
    return out


def sa_module_state(node: Mapping[str, Any], prefix: str = "") -> State:
    """flax SAModuleMSG -> port SAModuleMSG (mlps.{s}.layer{j}...)."""
    out = {}
    for s in range(_count(node, "SharedMLP_")):
        out.update(shared_mlp_state(node[f"SharedMLP_{s}"],
                                    _key(prefix, f"mlps.{s}")))
    return out


def fp_module_state(node: Mapping[str, Any], prefix: str = "") -> State:
    """flax FPModule -> port FPModule (mlp.layer{j}...)."""
    return shared_mlp_state(node["SharedMLP_0"], _key(prefix, "mlp"))


def _linear(out: State, prefix: str, dense: Mapping[str, Any]) -> None:
    out[f"{prefix}.weight"] = _a(dense["kernel"]).T.copy()
    out[f"{prefix}.bias"] = _a(dense["bias"])


def _norm(out: State, prefix: str, ln: Mapping[str, Any]) -> None:
    out[f"{prefix}.weight"] = _a(ln["scale"])
    out[f"{prefix}.bias"] = _a(ln["bias"])


def _mha(out: State, prefix: str, node: Mapping[str, Any]) -> None:
    E = _a(node["query"]["kernel"]).shape[0]
    out[f"{prefix}.in_proj_weight"] = np.concatenate(
        [_a(node[n]["kernel"]).reshape(E, E).T
         for n in ("query", "key", "value")])
    out[f"{prefix}.in_proj_bias"] = np.concatenate(
        [_a(node[n]["bias"]).reshape(E) for n in ("query", "key", "value")])
    out[f"{prefix}.out_proj.weight"] = _a(node["out"]["kernel"]).reshape(-1, E).T.copy()
    out[f"{prefix}.out_proj.bias"] = _a(node["out"]["bias"])


def mf_head_state(node: Mapping[str, Any], prefix: str = "") -> State:
    """flax MaskFormerHead -> port MaskFormerHead (reference MF_head keys)."""
    out = {_key(prefix, "query.weight"): _a(node["query"]["embedding"])}
    _linear(out, _key(prefix, "mlp_input.0"), node["MLP_0"]["Dense_0"])
    _linear(out, _key(prefix, "mlp_input.2"), node["MLP_0"]["Dense_1"])
    _norm(out, _key(prefix, "norm_input"), node["LayerNorm_0"])
    if "Dense_0" in node:
        _linear(out, _key(prefix, "input_pos_enc"), node["Dense_0"])
    for l in range(_count(node, "TransformerDecoderLayer_")):
        src = node[f"TransformerDecoderLayer_{l}"]
        tl = _key(prefix, f"transformer_layers.{l}")
        for i, name in enumerate(("norm_slot1", "norm_slot2", "norm_pre_ff")):
            _norm(out, f"{tl}.{name}", src[f"LayerNorm_{i}"])
        _mha(out, f"{tl}.cross_attn", src["MultiHeadDotProductAttention_0"])
        _mha(out, f"{tl}.self_attn", src["MultiHeadDotProductAttention_1"])
        _linear(out, f"{tl}.mlp.0", src["MLP_0"]["Dense_0"])
        _linear(out, f"{tl}.mlp.2", src["MLP_0"]["Dense_1"])
    return out


def segnet_state_dict_from_jax(flax_params: Mapping[str, Any]) -> State:
    """MaskFormer3D flax params ({'params': ...} or the bare tree) -> the
    reference state_dict as numpy arrays."""
    p = flax_params["params"] if "params" in flax_params else flax_params
    out: State = {}
    for i in range(_count(p, "sa")):
        out.update(sa_module_state(p[f"sa{i}"], f"SA_modules.{i}"))
    for i in range(_count(p, "fp")):
        out.update(fp_module_state(p[f"fp{i}"], f"FP_modules.{i}"))
    out.update(mf_head_state(p["mf_head"], "MF_head"))
    om0, om1 = p["object_mlp0"], p["object_mlp1"]
    out["object_mlp.0.conv.weight"] = _conv(om0["Dense_0"]["kernel"], 1)
    out["object_mlp.0.normlayer.gn.weight"] = _a(om0["GroupNorm_0"]["scale"])
    out["object_mlp.0.normlayer.gn.bias"] = _a(om0["GroupNorm_0"]["bias"])
    out["object_mlp.1.conv.weight"] = _conv(om1["Dense_0"]["kernel"], 1)
    out["object_mlp.1.conv.bias"] = _a(om1["Dense_0"]["bias"])
    return out


# Reference module prefix, flax module name, and whether its stack has
# BatchNorms (ogc_tpu/utils/torch_interop.py::_FLOW_SA_MAP).
FLOW_SA_MAP = [
    ("encoder_loc.sa1", "enc_loc_sa1", True),
    ("encoder_loc.sa2", "enc_loc_sa2", True),
    ("encoder_glob.sa1", "enc_glob_sa1", True),
    ("encoder_glob.sa2", "enc_glob_sa2", True),
    ("encoder_glob.sa3", "enc_glob_sa3", True),
    ("global_corr_layer.sa1", "corr_sa1", True),
    ("global_corr_layer.sa2", "corr_sa2", True),
    ("h0_net.sa1", "h0_sa1", True),
    ("h0_net.sa2", "h0_sa2", False),
    ("flow0_regressor.sa1", "flow0_sa1", True),
    ("flow_regressor.sa1", "flow_sa1", True),
    ("flow_regressor.sa2", "flow_sa2", True),
    ("gru.convz", "gru_convz", False),
    ("gru.convr", "gru_convr", False),
    ("gru.convq", "gru_convq", False),
    ("flow_conv1", "flow_conv1", True),
    ("flow_conv2", "flow_conv2", True),
    ("local_corr_layer", "local_corr", True),
]
FLOW_FC_MAP = [("flow0_regressor.fc", "flow0_fc"),
               ("flow_regressor.fc", "flow_fc")]


def flownet_state_dict_from_jax(variables: Mapping[str, Any]) -> State:
    """FlowStep3D flax variables ({'params', 'batch_stats'}) -> the
    reference state_dict as numpy arrays (conv weights (C_out, C_in, 1, 1),
    BatchNorm2d entries with ``num_batches_tracked`` 0)."""
    p, bs = variables["params"], variables["batch_stats"]
    out: State = {}
    for prefix, name, has_norm in FLOW_SA_MAP:
        if name not in p:
            continue  # absent in this arch (corr_sa2, enc_glob_sa3)
        stack = p[name]["_NormedConvStack_0"]
        for j in range(_count(stack, "Dense_")):
            out[f"{prefix}.mlp_convs.{j}.weight"] = _conv(
                stack[f"Dense_{j}"]["kernel"], 2)
            if not has_norm:
                continue
            bn = f"{prefix}.mlp_bns.{j}"
            norm = f"SchedulableBatchNorm_{j}"
            stats = bs[name]["_NormedConvStack_0"][norm]
            out[f"{bn}.weight"] = _a(stack[norm]["scale"])
            out[f"{bn}.bias"] = _a(stack[norm]["bias"])
            out[f"{bn}.running_mean"] = _a(stats["mean"])
            out[f"{bn}.running_var"] = _a(stats["var"])
            out[f"{bn}.num_batches_tracked"] = np.zeros((), np.int64)
    for prefix, name in FLOW_FC_MAP:
        _linear(out, prefix, p[name])
    out["global_corr_layer.epsilon"] = _a(p["epsilon"])
    return out
