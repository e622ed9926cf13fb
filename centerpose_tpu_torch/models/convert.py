"""JAX-package variables ↔ this package's `state_dict`.

The inverse direction of `centerpose_tpu/models/convert.py`: that module fills
the flax tree from a PyTorch `state_dict` of the reference's names; this one
takes the flax `{"params", "batch_stats"}` tree (nested dicts of numpy arrays)
and returns a `state_dict` of the same reference names, which are the names
this package's modules use. Layout changes:

  conv kernel            HWIO [kh, kw, I, O]  → OIHW
  depthwise upsampler    [2f, 2f, 1, C]       → ConvTranspose2d [C, 1, 2f, 2f]
                         (no flip: the JAX package flips when it applies it)
  DCN weight             [3, 3, C, Co]        → OIHW; offset/mask conv as any conv
  BatchNorm              scale/bias/mean/var  → weight/bias/running_mean/running_var

`to_jax_tree` goes the other way through the same names map (`_key_for`), so
that gradients, running statistics and updated parameters of the two packages
can be compared tree against tree.

The whole tree is walked: a leaf with no mapping is an error, and
`load_jax_variables` also refuses a leaf the model has no place for, a shape
that differs, and a model parameter no leaf fills.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
# The image stem and the tracking model's three previous-frame stems.
_STEMS = ("base_layer", "pre_img_layer", "pre_hm_layer", "pre_hm_hp_layer")


def _t_conv(w) -> np.ndarray:
    """HWIO → OIHW; also [k, k, 1, C] → [C, 1, k, k] for the upsampler."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _conv_leaf(leaf: str) -> Tuple[str, Callable]:
    if leaf == "kernel":
        return "weight", _t_conv
    if leaf == "bias":
        return "bias", np.asarray
    raise KeyError(leaf)


def _key_for(path: Tuple[str, ...], has_gn: bool) -> Tuple[str, Callable]:
    """Map a flax tree path (…, leaf) to (state_dict key, layout transform)."""
    parts = list(path)
    leaf = parts.pop()

    def conv_or_bn(prefix: str, sub: str, conv_name: str, bn_name: str):
        if sub == "conv":
            if leaf != "kernel":
                raise KeyError(leaf)
            return f"{prefix}.{conv_name}.weight", _t_conv
        if sub == "bn":
            return f"{prefix}.{bn_name}.{_BN[leaf]}", np.asarray
        raise KeyError(sub)

    if parts[0] == "base":
        # Stems: base/{base,pre_img,pre_hm,pre_hm_hp}_layer/conv/{conv,bn};
        # Sequential idx 0 = conv, 1 = bn.
        if parts[1] in _STEMS and len(parts) == 4 and parts[2] == "conv":
            return conv_or_bn(f"base.{parts[1]}", parts[3], "0", "1")
        # Conv levels: base/level{0,1}/conv{i}/{conv,bn}; Sequential [conv,bn,relu]*n.
        if re.fullmatch(r"level[01]", parts[1]) and len(parts) == 4:
            i = int(re.fullmatch(r"conv(\d+)", parts[2]).group(1))
            return conv_or_bn(f"base.{parts[1]}", parts[3], str(3 * i), str(3 * i + 1))
        # Trees: nested tree1/tree2, then project | root | conv1 | conv2.
        if re.fullmatch(r"level[2-5]", parts[1]):
            prefix = ["base", parts[1]]
            i = 2
            while i < len(parts) and parts[i] in ("tree1", "tree2"):
                prefix.append(parts[i])
                i += 1
            pre = ".".join(prefix)
            rest = parts[i:]
            if len(rest) == 2 and rest[0] == "project":
                return conv_or_bn(f"{pre}.project", rest[1], "0", "1")
            if len(rest) == 3 and rest[0] == "root" and rest[1] == "conv":
                return conv_or_bn(f"{pre}.root", rest[2], "conv", "bn")
            if len(rest) == 2 and rest[0] in ("conv1", "conv2"):
                n = rest[0][-1]
                return conv_or_bn(pre, rest[1], f"conv{n}", f"bn{n}")

    # DLAUp / IDAUp stages: {dla_up/ida_k | ida_up}/stage_i/{proj,up,node}.
    if parts[0] in ("dla_up", "ida_up"):
        if parts[0] == "dla_up":
            base, stage, rest = f"dla_up.{parts[1]}", parts[2], parts[3:]
        else:
            base, stage, rest = "ida_up", parts[1], parts[2:]
        idx = re.fullmatch(r"stage_(\d+)", stage).group(1)
        comp = rest[0]
        if comp == "up" and len(rest) == 1 and leaf == "kernel":
            return f"{base}.up_{idx}.weight", _t_conv
        if comp in ("proj", "node"):
            tkey = f"{base}.{comp}_{idx}"
            if len(rest) == 1:                      # the DCN's own weight / bias
                if leaf == "weight":
                    return f"{tkey}.conv.weight", _t_conv
                if leaf == "bias":
                    return f"{tkey}.conv.bias", np.asarray
            elif len(rest) == 2 and rest[1] == "conv_offset_mask":
                name, fn = _conv_leaf(leaf)
                return f"{tkey}.conv.conv_offset_mask.{name}", fn
            elif len(rest) == 2 and rest[1] == "bn":
                return f"{tkey}.actf.0.{_BN[leaf]}", np.asarray

    # ConvGRU cells: convGRU/cell0/W??/{kernel,bias}.
    if parts[0] == "convGRU" and len(parts) == 3:
        name, fn = _conv_leaf(leaf)
        return f"convGRU.{parts[1]}.{parts[2]}.{name}", fn

    # Heads: <head>/{conv1,gn,out}; Sequential [conv, (GN), ReLU, conv].
    if len(parts) == 2 and parts[1] in ("conv1", "gn", "out"):
        head, sub = parts
        if sub == "gn":
            return f"{head}.1.{'weight' if leaf == 'scale' else _BN[leaf]}", np.asarray
        name, fn = _conv_leaf(leaf)
        idx = "0" if sub == "conv1" else ("3" if has_gn else "2")
        return f"{head}.{idx}.{name}", fn

    raise KeyError("/".join(path))


def _has_gn(params: Mapping[str, Any]) -> bool:
    return any(isinstance(v, Mapping) and "gn" in v for v in params.values())


def _lookup(path: Tuple[str, ...], has_gn: bool) -> Tuple[str, Callable]:
    try:
        return _key_for(path, has_gn)
    except (KeyError, AttributeError, IndexError) as err:
        raise KeyError(f"no state_dict name for the leaf {'/'.join(path)}") from err


def from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The `state_dict` (float32 CPU tensors, reference names) for a flax
    variables tree `{"params": ..., "batch_stats": ...}` of numpy arrays."""
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unknown variable collections: {sorted(extra)}")
    params = variables["params"]
    has_gn = _has_gn(params)
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        if isinstance(tree, Mapping):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        key, transform = _lookup(path, has_gn)
        if key in out:
            raise KeyError(f"two leaves map to {key!r} ({'/'.join(path)})")
        out[key] = torch.from_numpy(
            np.array(transform(np.asarray(tree)), dtype=np.float32)
        )

    walk(params, ())
    walk(variables.get("batch_stats", {}), ())
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.zeros(
            (), dtype=torch.int64
        )
    return out


def to_jax_tree(named: Mapping[str, Any], like: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of `from_jax_variables`: a tree with the structure of
    `like` (a flax variables tree, or a part of one such as `{"params": ...}`)
    whose leaves are the entries of `named` (tensors or arrays by `state_dict`
    name: parameters, their gradients, buffers) as float32 numpy arrays in the
    JAX package's layouts. Every leaf of `like` must have its entry."""
    extra = set(like) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unknown variable collections: {sorted(extra)}")
    has_gn = _has_gn(like.get("params", {}))     # only names of `params` depend on it

    def walk(tree, path):
        if isinstance(tree, Mapping):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        key, transform = _lookup(path, has_gn)
        if key not in named:
            raise KeyError(f"{key!r} (leaf {'/'.join(path)}) is not among the named tensors")
        val = named[key]
        val = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        if transform is _t_conv:                       # OIHW → HWIO
            val = np.transpose(val, (2, 3, 1, 0))
        return np.ascontiguousarray(val, dtype=np.float32)

    return {coll: walk(tree, ()) for coll, tree in like.items()}


def load_jax_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> None:
    """Fill `model` from a flax variables tree. Every leaf must land on a
    parameter or buffer of the same shape and every parameter must be filled."""
    sd = from_jax_variables(variables)
    own = model.state_dict()
    unknown = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd))
    if unknown or missing:
        raise KeyError(
            f"state_dict mismatch: not in the model {unknown[:8]}, "
            f"not in the variables {missing[:8]}"
        )
    for key, val in sd.items():
        if tuple(val.shape) != tuple(own[key].shape):
            raise ValueError(
                f"shape mismatch for {key}: variables {tuple(val.shape)} vs "
                f"model {tuple(own[key].shape)}"
            )
    model.load_state_dict(sd, strict=True)
