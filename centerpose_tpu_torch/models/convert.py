"""JAX-package variables ↔ this package's `state_dict`, and loading a
reference checkpoint.

The inverse direction of `centerpose_tpu/models/convert.py`: that module fills
the flax tree from a PyTorch `state_dict` of the reference's names; this one
takes the flax `{"params", "batch_stats"}` tree (nested dicts of numpy arrays)
and returns a `state_dict` of the same reference names, which are the names
this package's modules use, for every architecture of the factory (the DLA
networks, dlav0, res / resdcn, hourglass). Layout changes:

  conv kernel            HWIO [kh, kw, I, O]  → OIHW
  depthwise upsampler    [2f, 2f, 1, C]       → ConvTranspose2d [C, 1, 2f, 2f]
                         (no flip: the JAX package flips when it applies it)
  full transposed conv   [k, k, I, O]         → ConvTranspose2d [I, O, k, k]
                         (no flip either; resnet deconv stages)
  DCN weight             [3, 3, C, Co]        → OIHW; offset/mask conv as any conv
  BatchNorm              scale/bias/mean/var  → weight/bias/running_mean/running_var

Two names depend on the tree as a whole, as in the JAX converter: a head's
output conv is `{head}.3` after a GroupNorm and `{head}.2` without, and the
BatchNorm after a resnet transposed conv is `deconv_layers.{6i+4}` in a
resdcn tree, `{3i+1}` in a msra one. A `head_conv <= 0` head (flax `{head}/out`
with no `conv1`) is the reference's bare conv `{head}.weight` / `{head}.bias`.

`to_jax_tree` goes the other way through the same names map (`_key_for`), so
that gradients, running statistics and updated parameters of the two packages
can be compared tree against tree.

The whole tree is walked: a leaf with no mapping is an error, and
`load_jax_variables` also refuses a leaf the model has no place for, a shape
that differs, and a model parameter no leaf fills. `load_reference_state_dict`
loads a reference checkpoint with the reference's own rules.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
# The image stem and the tracking model's three previous-frame stems.
_STEMS = ("base_layer", "pre_img_layer", "pre_hm_layer", "pre_hm_hp_layer")


def _t_conv(w) -> np.ndarray:
    """HWIO → OIHW; also [k, k, 1, C] → [C, 1, k, k] for the upsampler."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _t_conv_back(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _t_deconv(w) -> np.ndarray:
    """[k, k, I, O] ↔ [I, O, k, k] (its own inverse)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 0, 1)))


_INVERSE = {_t_conv: _t_conv_back, _t_deconv: _t_deconv, np.asarray: np.asarray}


class _Tree(NamedTuple):
    """What a name depends on beyond its own path."""
    has_gn: bool          # heads with GroupNorm (the convGRU models)
    bare_heads: bool      # head_conv <= 0
    resdcn: bool          # resnet deconv stages with DCN
    hourglass: bool       # per-stack heads {head}_{s}


def _tree_of(variables: Mapping[str, Any]) -> _Tree:
    tops = {k: v for coll in variables.values() for k, v in coll.items()}
    heads = [v for v in tops.values() if isinstance(v, Mapping) and "out" in v]
    return _Tree(
        has_gn=any("gn" in v for v in heads),
        bare_heads=any("conv1" not in v for v in heads),
        resdcn="deconv_dcn0" in tops,
        hourglass="hg_0" in tops,
    )


def _conv_leaf(leaf: str) -> Tuple[str, Callable]:
    if leaf == "kernel":
        return "weight", _t_conv
    if leaf == "bias":
        return "bias", np.asarray
    raise KeyError(leaf)


def _key_for(path: Tuple[str, ...], tree: _Tree) -> Tuple[str, Callable]:
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

    def dcn(prefix: str, rest, bn_key: str):
        """A flax DeformConvBlock under `prefix` (the DCN module's name):
        its own weight / bias, its offset conv, its BatchNorm at `bn_key`."""
        if not rest:
            if leaf == "weight":
                return f"{prefix}.weight", _t_conv
            if leaf == "bias":
                return f"{prefix}.bias", np.asarray
        elif rest == ["conv_offset_mask"]:
            name, fn = _conv_leaf(leaf)
            return f"{prefix}.conv_offset_mask.{name}", fn
        elif rest == ["bn"]:
            return f"{bn_key}.{_BN[leaf]}", np.asarray
        raise KeyError("/".join(rest))

    def residual(prefix: str, comp: str, sub: str):
        """CornerNet residual: conv1/bn1, conv2/bn2, skip.0/skip.1."""
        if comp == "skip":
            return conv_or_bn(f"{prefix}.skip", sub, "0", "1")
        n = re.fullmatch(r"conv([12])", comp).group(1)
        return conv_or_bn(prefix, sub, f"conv{n}", f"bn{n}")

    top = parts[0]
    if top == "base":
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

    # The dlav0 neck: dla_up/ida_i/{proj_j,node_j}/{conv,bn} (Sequential
    # [conv, bn, relu]) and dla_up/ida_i/up_j/kernel.
    if top == "dla_up" and len(parts) >= 3 and re.fullmatch(r"(proj|up|node)_\d+", parts[2]):
        base = f"dla_up.{parts[1]}.{parts[2]}"
        if parts[2].startswith("up_") and len(parts) == 3 and leaf == "kernel":
            return f"{base}.weight", _t_conv
        if len(parts) == 4:
            return conv_or_bn(base, parts[3], "0", "1")

    # DLAUp / IDAUp stages: {dla_up/ida_k | ida_up}/stage_i/{proj,up,node}.
    if top in ("dla_up", "ida_up"):
        if top == "dla_up":
            base, stage, rest = f"dla_up.{parts[1]}", parts[2], parts[3:]
        else:
            base, stage, rest = "ida_up", parts[1], parts[2:]
        idx = re.fullmatch(r"stage_(\d+)", stage).group(1)
        comp = rest[0]
        if comp == "up" and len(rest) == 1 and leaf == "kernel":
            return f"{base}.up_{idx}.weight", _t_conv
        if comp in ("proj", "node"):
            tkey = f"{base}.{comp}_{idx}"
            return dcn(f"{tkey}.conv", rest[1:], f"{tkey}.actf.0")

    # ConvGRU cells: convGRU/cell0/W??/{kernel,bias}.
    if top == "convGRU" and len(parts) == 3:
        name, fn = _conv_leaf(leaf)
        return f"convGRU.{parts[1]}.{parts[2]}.{name}", fn

    # ResNet trunk: stem/{conv,bn} and layer{s}_{b}/{conv{n},downsample}/{conv,bn}.
    if top == "stem" and len(parts) == 2:
        if parts[1] == "conv" and leaf == "kernel":
            return "conv1.weight", _t_conv
        if parts[1] == "bn":
            return f"bn1.{_BN[leaf]}", np.asarray
    m = re.fullmatch(r"layer(\d+)_(\d+)", top)
    if m and len(parts) == 3:
        pre = f"layer{m.group(1)}.{m.group(2)}"
        if parts[1] == "downsample":
            return conv_or_bn(f"{pre}.downsample", parts[2], "0", "1")
        n = re.fullmatch(r"conv(\d)", parts[1]).group(1)
        return conv_or_bn(pre, parts[2], f"conv{n}", f"bn{n}")
    # ResNet deconv stages (Sequential deconv_layers): msra [convT, BN, ReLU]
    # x 3; resdcn [DCN, BN, ReLU, convT, BN, ReLU] x 3.
    m = re.fullmatch(r"deconv(_bn|_dcn|_up)?(\d+)", top)
    if m:
        kind, i = m.group(1), int(m.group(2))
        if kind is None and len(parts) == 1 and leaf == "kernel":
            return f"deconv_layers.{3 * i}.weight", _t_deconv
        if kind == "_up" and len(parts) == 1 and leaf == "kernel":
            return f"deconv_layers.{6 * i + 3}.weight", _t_deconv
        if kind == "_bn" and len(parts) == 1:
            return f"deconv_layers.{6 * i + 4 if tree.resdcn else 3 * i + 1}.{_BN[leaf]}", np.asarray
        if kind == "_dcn":
            return dcn(f"deconv_layers.{6 * i}", parts[1:], f"deconv_layers.{6 * i + 1}")

    # Hourglass: pre_conv / pre_res, hg_{s}/... kp modules, feat_{s},
    # inter_{a,b}_{s}, inter_res_{s}, per-stack heads {head}_{s}.
    if top == "pre_conv" and len(parts) == 2:
        return conv_or_bn("pre.0", parts[1], "conv", "bn")
    if top == "pre_res" and len(parts) == 3:
        return residual("pre.1", parts[1], parts[2])
    m = re.fullmatch(r"hg_(\d+)", top)
    if m and len(parts) >= 4:
        toks = ["kps", m.group(1)]
        for p in parts[1:-2]:
            mm = re.fullmatch(r"(up1|low1|low2|low3)_(\d+)", p)
            if mm:
                toks += [mm.group(1), mm.group(2)]
            elif p == "low2":
                toks.append(p)
            else:
                raise KeyError(p)
        return residual(".".join(toks), parts[-2], parts[-1])
    m = re.fullmatch(r"feat_(\d+)", top)
    if m and len(parts) == 2:
        return conv_or_bn(f"cnvs.{m.group(1)}", parts[1], "conv", "bn")
    m = re.fullmatch(r"inter_(a|b)_(\d+)", top)
    if m and len(parts) == 2:
        seq = "inters_" if m.group(1) == "a" else "cnvs_"
        return conv_or_bn(f"{seq}.{m.group(2)}", parts[1], "0", "1")
    m = re.fullmatch(r"inter_res_(\d+)", top)
    if m and len(parts) == 3:
        return residual(f"inters.{m.group(1)}", parts[1], parts[2])

    # Heads: <head>/{conv1,gn,out}; Sequential [conv, (GN), ReLU, conv], or
    # the bare conv of head_conv <= 0; the hourglass's {head}_{s}/{conv1,out}
    # is `{head}.{s}` = [convolution (conv with bias), 1x1 conv].
    if len(parts) == 2 and parts[1] in ("conv1", "gn", "out"):
        head, sub = parts
        if tree.hourglass:
            m = re.fullmatch(r"(.+)_(\d+)", head)
            if sub == "gn" or not m:
                raise KeyError(head)
            name, fn = _conv_leaf(leaf)
            where = "0.conv" if sub == "conv1" else "1"
            return f"{m.group(1)}.{m.group(2)}.{where}.{name}", fn
        if sub == "gn":
            return f"{head}.1.{'weight' if leaf == 'scale' else _BN[leaf]}", np.asarray
        name, fn = _conv_leaf(leaf)
        if sub == "conv1":
            return f"{head}.0.{name}", fn
        if tree.bare_heads:
            return f"{head}.{name}", fn
        return f"{head}.{'3' if tree.has_gn else '2'}.{name}", fn

    raise KeyError("/".join(path))


def _lookup(path: Tuple[str, ...], tree: _Tree) -> Tuple[str, Callable]:
    try:
        return _key_for(path, tree)
    except (KeyError, AttributeError, IndexError) as err:
        raise KeyError(f"no state_dict name for the leaf {'/'.join(path)}") from err


def from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The `state_dict` (float32 CPU tensors, reference names) for a flax
    variables tree `{"params": ..., "batch_stats": ...}` of numpy arrays."""
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unknown variable collections: {sorted(extra)}")
    params = variables["params"]
    tree_kind = _tree_of(variables)
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        if isinstance(tree, Mapping):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        key, transform = _lookup(path, tree_kind)
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
    tree_kind = _tree_of(like)

    def walk(tree, path):
        if isinstance(tree, Mapping):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        key, transform = _lookup(path, tree_kind)
        if key not in named:
            raise KeyError(f"{key!r} (leaf {'/'.join(path)}) is not among the named tensors")
        val = named[key]
        val = val.detach().cpu().float().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        return np.ascontiguousarray(_INVERSE[transform](val), dtype=np.float32)

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


# Keys of a reference checkpoint that no network of this package has and
# that the reference's loader also passes over: BatchNorm step counters, and
# the ImageNet classifier that released dlav0 checkpoints keep in the trunk
# (`base.fc.*`; centerpose_tpu/models/convert.py:347-351).
_IGNORABLE = re.compile(r"num_batches_tracked$|^fc\.|\.fc\.")


def load_reference_state_dict(model: torch.nn.Module, checkpoint: Mapping[str, Any]) -> None:
    """Load a reference checkpoint into `model`: a `state_dict`, or a
    checkpoint dict holding one under "state_dict" (`{epoch, state_dict,
    optimizer}`, the reference's `save_model`). DataParallel's `module.`
    prefixes are stripped; keys matching `_IGNORABLE` that the model lacks
    are skipped (and a missing `num_batches_tracked` keeps the model's);
    every other name and shape must be the model's, else KeyError /
    ValueError before anything is written."""
    sd = checkpoint.get("state_dict", checkpoint)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    own = model.state_dict()
    unknown = sorted(k for k in set(sd) - set(own) if not _IGNORABLE.search(k))
    missing = sorted(k for k in set(own) - set(sd) if not k.endswith("num_batches_tracked"))
    if unknown or missing:
        raise KeyError(
            f"checkpoint mismatch: not in the model {unknown[:8]}, not in the checkpoint {missing[:8]}")
    for key, val in sd.items():
        if key in own and tuple(val.shape) != tuple(own[key].shape):
            raise ValueError(
                f"shape mismatch for {key}: checkpoint {tuple(val.shape)} vs model {tuple(own[key].shape)}")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items() if k in own}, strict=False)
