"""bf16 mixed-precision training in the PyTorch package, against the JAX package, on the CPU.

Three parts:

* The plain bf16-operand backward of the deformable convolution
  (`ops/dcn_bwd.py::dcn_v2_grads_plain` on bf16 x, weight and dout, float32
  offset and mask) against the JAX package's Pallas backward with
  `compute_dtype=bfloat16`, run in interpret mode as `tests/test_dcn_bwd.py`
  runs it. The same bf16 operands on both sides; the JAX kernel also rounds
  gs and the modulated samples to bf16 (2^-9 of each term), the port returns
  dx and dW in bf16 (2^-9 again), so each term is held to 2e-2 of its largest
  magnitude plus 1e-3 (about 2^-8 twice over, the tolerance `chip_smoke.py`
  holds the CUDA bf16 body to); measured: 7.4e-3 at worst.
* One mixed-precision step of dlav1_34 at 64x64, batch 2 (float32
  parameters, the forward under `torch.autocast(bf16)`), against the JAX
  bf16 step (flax modules in bf16, float32 parameters) on the same weights
  and batch, with BatchNorm on running statistics: loss and every stat,
  then every gradient.
* The bf16 body's tiling (`bwd_plan(dtype=bf16)`, the mirror of
  `dcn_v2_bwd_plan(kind, 1, ...)`), its instructions and entry points in
  `csrc/dcn_v2_bwd.cu`, and the wrapper's bf16 launches, as
  `tests/test_torch_port_dcn_bwd_sm90.py` checks the float32 body.
"""

import contextlib
import re
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from centerpose_tpu.config import preset as jax_preset
from centerpose_tpu.models import create_model as jax_create_model
from centerpose_tpu.ops.dcn_bwd import dcn_v2_grads as jax_dcn_v2_grads
from centerpose_tpu.training import trainer as jax_trainer
from centerpose_tpu.training.losses import centerpose_loss as jax_centerpose_loss
from centerpose_tpu_torch import _build
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.models import layers
from centerpose_tpu_torch.models.convert import load_jax_variables, to_jax_tree
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.ops import dcn_bwd
from centerpose_tpu_torch.ops.dcn_bwd import bwd_plan
from centerpose_tpu_torch.training import trainer
from centerpose_tpu_torch.training.losses import centerpose_loss
from tests.test_dcn_bwd import NAMES, _inputs
from tests.test_torch_port_model import randomize_variables
from tests.test_torch_port_training import annotations

BF16 = torch.bfloat16
TOL_REL, TOL_ABS = 2e-2, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's 64x64 steps: they gain nothing from
    a thread pool, and under the suite's parallel workers a pool in every
    process oversubscribes the cores (a 64x64 batch norm then takes ~70 ms
    instead of well under one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------ the plain bf16 backward
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("b,h,w,c,co,off_scale,integer", [
    (2, 8, 16, 8, 8, 0.9, False),        # generic small offsets
    (2, 8, 16, 8, 8, 25.0, False),       # most samples off the image
    (2, 8, 16, 8, 8, 0.0, True),         # integer offsets (a fresh offset conv)
    (1, 8, 16, 32, 8, 1.1, False),       # C > W
])
def test_plain_bf16_grads_match_the_jax_bf16_kernel(b, h, w, c, co, off_scale, integer, fused):
    rng = np.random.RandomState(5)
    args = _inputs(rng, b, h, w, c, co, off_scale, integer)
    ref = jax_dcn_v2_grads(*args, compute_dtype=jnp.bfloat16, fused=fused)
    x, off, m, wt, bi, g = (torch.from_numpy(np.array(a)) for a in args)
    got = dcn_bwd.dcn_v2_grads_plain(x.to(BF16), off, m, wt.to(BF16), bi, g.to(BF16))
    assert [t.dtype for t in got] == [BF16, torch.float32, torch.float32, BF16, torch.float32]
    for name, r, k in zip(NAMES, ref, got):
        r = np.asarray(r, np.float64)
        err = np.abs(k.double().numpy() - r).max()
        assert err <= TOL_REL * np.abs(r).max() + TOL_ABS, (name, err)


def test_wrappers_take_bf16_operands_on_the_cpu():
    """On the CPU every backward wrapper gives the plain bf16-operand
    version's terms, in the operands' types."""
    rng = np.random.RandomState(2)
    x, off, m, wt, bi, g = (torch.from_numpy(np.array(a)).to(BF16)
                            for a in _inputs(rng, 2, 8, 16, 8, 8, 1.3))
    ref = dcn_bwd.dcn_v2_grads_plain(x, off, m, wt, bi, g)
    assert all(t.dtype == BF16 for t in ref)
    for fused in (True, False):
        got = dcn_bwd.dcn_v2_grads(x, off, m, wt, bi, g, fused=fused)
        for name, r, k in zip(NAMES, ref, got):
            assert k.dtype == r.dtype and torch.equal(k, r), (fused, name)


# ------------------------------------------------ one mixed-precision step
RES = 64
BATCH = 2


class Bf16Pair:
    """The two packages' bf16 networks with the same float32 weights, their
    train-phase losses and gradients with BatchNorm on running statistics,
    and the port's float32 gradient on the same weights (the yardstick)."""

    def __init__(self):
        over = dict(input_h=RES, input_w=RES, batch_size=BATCH, compute_dtype="bfloat16")
        jcfg = jax_preset("centerpose", dcn_impl="gather", dcn_bwd="autodiff",
                          remat_dcn=False, remat_stem=False, **over)
        self.tcfg = preset("centerpose", **over)
        jmodel = jax_create_model(jcfg)
        variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3), jnp.float32))
        self.variables = randomize_variables(variables, seed=0)
        rng = np.random.RandomState(0)
        from centerpose_tpu_torch.data import targets
        samples = [targets.render_targets(annotations(targets, self.tcfg, rng), self.tcfg)
                   for _ in range(BATCH)]
        self.batch = targets.stack_batch(samples)
        self.batch["input"] = rng.randn(BATCH, RES, RES, 3).astype(np.float32)

        jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        loss_cfg = jax_trainer.loss_config_from(jcfg)
        bstats = jax.tree_util.tree_map(jnp.asarray, self.variables["batch_stats"])

        def loss_fn(params):
            outputs = jmodel.apply({"params": params, "batch_stats": bstats}, jbatch["input"],
                                   train=False)
            loss, stats, _ = jax_centerpose_loss(outputs, jbatch, loss_cfg, "train")
            return loss, stats

        params = jax.tree_util.tree_map(jnp.asarray, self.variables["params"])
        (self.jloss, self.jstats), self.jgrads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)

        self.loss, self.stats, self.grads, self.model = self.port_step("bfloat16")
        self.loss32, _, self.grads32, _ = self.port_step("float32")

    def port_step(self, dtype):
        cfg = self.tcfg.replace(compute_dtype=dtype)
        model = create_model(cfg, device="cpu", param_dtype="float32")
        load_jax_variables(model, self.variables)
        model.eval()
        tbatch = {k: torch.from_numpy(v) for k, v in self.batch.items()}
        with trainer._compute(cfg, torch.device("cpu")):
            outputs = model(tbatch["input"])
        loss, stats, _ = centerpose_loss(outputs, tbatch, trainer.loss_config_from(cfg), "train")
        loss.backward()
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in model.named_parameters()}
        tree = to_jax_tree(grads, {"params": self.variables["params"]})["params"]
        return loss.item(), {k: v.item() for k, v in stats.items()}, tree, model


@pytest.fixture(scope="module")
def bf16_pair():
    return Bf16Pair()


def _leaves(tree):
    return [(str(p), np.asarray(v, np.float64)) for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def test_bf16_step_loss_and_stats(bf16_pair):
    """Loss and every stat within 1e-2 relative (+1e-3): each layer rounds
    its activations to bf16 (2^-9) at other places in the two packages
    (autocast's op lists against flax's dtype), about 2^-8 per element; the
    losses are sums over the head maps. Measured: 5.5e-4 for the loss,
    2.2e-3 for the worst stat."""
    p = bf16_pair
    assert np.isfinite(p.loss) and p.loss > 1.0
    np.testing.assert_allclose(p.loss, float(p.jloss), rtol=1e-2)
    assert set(p.stats) == set(p.jstats)
    for k, ref in p.jstats.items():
        np.testing.assert_allclose(p.stats[k], float(ref), rtol=1e-2, atol=1e-3, err_msg=k)
    assert abs(p.loss - float(p.jloss)) < abs(p.loss32 - float(p.jloss)) + 1e-2 * p.loss


def test_bf16_step_gradients(bf16_pair):
    """Every parameter's gradient against the JAX bf16 gradient, tree against
    tree. Rounded to bf16 at each of ~40 layers forward and back, a bf16
    gradient stands off the float32 one by a few percent (the port's own:
    3.1 % of the tree in L2, 4.7 % at the median leaf; the JAX package's own
    is larger), and the two packages' bf16 gradients stand off each other by
    as much (3.8 %, 4.3 %). So the whole tree and the median leaf are held to
    twice the port's bf16-to-float32 distance (+2e-2 for the tree), and
    every leaf to 0.6 in relative L2: a wrong sign, a missing term or a
    gradient stopped at a cast gives 1 or more there. The 16 deformable
    convolutions' offset convs must get gradients (the bf16 path reaches
    them)."""
    p = bf16_pair
    got, ref, f32 = _leaves(p.grads), _leaves(p.jgrads), _leaves(p.grads32)
    assert [k for k, _ in got] == [k for k, _ in ref] == [k for k, _ in f32]
    assert all(g.dtype == torch.float32 for g in (q.grad for q in p.model.parameters()) if g is not None)
    live = [i for i, (_, r) in enumerate(ref) if np.linalg.norm(r) > 1e-8]
    assert len(live) > 250
    to_jax = [_rel(got[i][1], ref[i][1]) for i in live]
    to_f32 = [_rel(got[i][1], f32[i][1]) for i in live]
    assert max(to_jax) < 0.6, max(zip(to_jax, (got[i][0] for i in live)))
    assert np.median(to_jax) <= 2 * np.median(to_f32), (np.median(to_jax), np.median(to_f32))
    flat = [np.concatenate([v.ravel() for _, v in t]) for t in (got, ref, f32)]
    tree_f32 = _rel(flat[0], flat[2])
    assert tree_f32 < 0.1
    assert _rel(flat[0], flat[1]) <= 2 * tree_f32 + 2e-2, (_rel(flat[0], flat[1]), tree_f32)
    offsets = [v for k, v in got if "conv_offset_mask" in k]
    assert len(offsets) == 32 and all(np.abs(v).max() > 0 for v in offsets)


def test_bf16_train_step_keeps_float32_state():
    """`make_train_step` on a bf16 config: float32 parameters, gradients,
    BatchNorm statistics and Adam moments; the DCN blocks' operands bf16 in
    the forward; a bf16-parameter model is refused for training."""
    cfg = preset("centerpose", arch="dla_34", input_h=RES, input_w=RES, batch_size=BATCH,
                 compute_dtype="bfloat16")
    model = create_model(cfg, device="cpu", param_dtype="float32")
    seen = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: seen.append(out.dtype))
             for m in model.modules() if isinstance(m, layers.DCN)]
    state, tx = trainer.create_train_state(cfg, model, steps_per_epoch=3)
    from centerpose_tpu_torch.data import targets
    rng = np.random.RandomState(1)
    batch = targets.stack_batch([targets.render_targets(annotations(targets, cfg, rng), cfg)
                                 for _ in range(BATCH)])
    batch["input"] = rng.randn(BATCH, RES, RES, 3).astype(np.float32)
    state, stats = trainer.make_train_step(cfg, model, tx)(state, batch)
    for h in hooks:
        h.remove()
    assert seen == [BF16] * 16 and np.isfinite(stats["loss"].item())
    assert stats["loss"].dtype == torch.float32 and state.step == 1 and tx.norm.dtype == torch.float32
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype in (torch.float32, torch.int64) for b in model.buffers())
    assert all(v.dtype == torch.float32 for s in tx.adam.state.values()
               for k, v in s.items() if k != "step")
    with pytest.raises(ValueError, match="float32 parameters"):
        trainer.create_train_state(cfg, torch.nn.Conv2d(3, 8, 1).to(BF16))


# ------------------------------------------------------- the bf16 body
PRODUCTION = [(128, 64, 64), (64, 128, 128), (64, 128, 64), (32, 256, 256),
              (32, 256, 128), (32, 256, 64), (16, 512, 256)]
TAILS = [(9, 11, 8, 8), (9, 11, 24, 40), (9, 11, 72, 200), (9, 11, 64, 136)]
SHAPES = ([(b, hw, hw, c, co) for hw, c, co in PRODUCTION for b in (2, 8)]
          + [(b, h, w, c, co) for h, w, c, co in TAILS for b in (1, 2)])
KERNELS = ("fused", "dx", "dcoord", "dw")
SM_SHARED_BYTES = 228 * 1024
BLOCK_SHARED_MAX = 227 * 1024
BLOCK_RESERVED = 1024


def _source() -> str:
    return (_build.CSRC / "dcn_v2_bwd.cu").read_text()


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("b,h,w,c,co", SHAPES)
def test_bf16_plan_tiles_as_float32_and_fits(kernel, b, h, w, c, co):
    """The bf16 body tiles every call as the float32 body does (grid,
    chunks, Co tiles: every sample in exactly one block); its shared memory
    is the dout tile, gs and the column tile in bf16, less than the float32
    hi/lo tiles, within one block's and the SM's shared memory; its scratch
    holds the weight's bf16 fragments in K steps of 16 (zero past Co)."""
    f32 = bwd_plan(kernel, b, h, w, c, co)
    bf = bwd_plan(kernel, b, h, w, c, co, dtype=BF16)
    same = ("block_m", "tiles", "grid_y", "grid_z", "chunks_per_block", "co_tiles")
    assert {k: bf[k] for k in same} == {k: f32[k] for k in same}
    nco, gs, dw = f32["co_tiles"], kernel != "dw", kernel in ("fused", "dw")
    assert bf["smem_bytes"] == 2 * 64 * (64 * nco + 64 * gs + 64 * dw) + 64 * 24
    assert bf["smem_bytes"] < f32["smem_bytes"] <= BLOCK_SHARED_MAX
    assert bf["blocks_per_sm"] * (bf["smem_bytes"] + BLOCK_RESERVED) <= SM_SHARED_BYTES
    assert bf["blocks_per_sm"] >= f32["blocks_per_sm"] >= 1
    frags = 9 * c * -(-co // 16) * 16 // 2 if gs else 0          # bf16 pairs, in floats
    partials = f32["scratch_floats"] - (2 * 9 * c * co if gs else 0)
    if bf["slabs"] == f32["slabs"]:
        assert bf["scratch_floats"] == frags + partials
    assert bf["scratch_floats"] * 4 < 25 * 2 ** 20


def test_bf16_source_mirrors_and_instructions():
    """The source numbers the operand types as the wrapper does, states the
    bf16 shared memory as `bwd_plan` does, builds both products from bf16
    tensor-core instructions with float32 accumulators, keeps dX a float32
    atomic sum (no bf16 atomics), rounds gs and the columns to bf16 where
    they are written, and exports the four bf16 entry points and the typed
    plan."""
    src = _source()
    assert "enum DType { F32 = 0, BF16 = 1 };" in src and dcn_bwd.BWD_DTYPES == {torch.float32: 0, BF16: 1}
    assert ("p->smem = 2 * BM * (64 * p->nco + (has_gs(kind) ? BC : 0) + (has_dw(kind) ? BC : 0)) + BM * 24;"
            in src)
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    body = src[src.index("dcn_v2_bwd_kernel(const BwdArgs a)"):src.index("weight_fragments_kernel")]
    assert body.count("mma_bf16(") == 2 and body.count("mma3(") == 2          # gs and dW, each type
    assert body.count("pack_bf16(") >= 3                                        # gs (2 halves) and columns
    assert "atomicAdd" not in body and "__hadd" not in body and "bfloat162" not in body
    assert "weight_fragments_bf16_kernel" in src
    assert re.search(r'extern "C" int dcn_v2_bwd_plan\(int kind, int dtype,', src)
    for kind, code in zip(KERNELS, range(4)):
        assert (f'extern "C" int dcn_v2_bwd_{kind}_bf16_launch(DCN_BWD_ARGS) '
                f'{{ return launch({code}, BF16, DCN_BWD_PASS); }}') in src
        assert (f'extern "C" int dcn_v2_bwd_{kind}_launch(DCN_BWD_ARGS) '
                f'{{ return launch({code}, F32, DCN_BWD_PASS); }}') in src
    assert "cublas" not in src.lower() and "cudnn" not in src.lower()


def test_bf16_rounding_of_gs_and_columns_stays_in_tolerance():
    """What the bf16 body adds to the plain bf16-operand version: gs and the
    modulated samples rounded to bf16 before their products, and every term
    summed in float32. At the widest production products (K = 9 x 512 for
    gs, 8 x 16 x 16 pixels for dW) that moves each term by well under
    TOL_REL of its largest magnitude."""
    gen = torch.Generator().manual_seed(0)
    dout = torch.randn(512, 256, generator=gen).to(BF16).float()          # [px, Co]
    w = (torch.randn(9 * 512, 256, generator=gen) / 48).to(BF16).float()   # [9C, Co]
    gs = dout @ w.T                                                         # [px, 9C]
    cols = torch.randn(512, 9 * 512, generator=gen)
    for exact, rounded in ((gs * cols).sum(1), (gs.to(BF16).float() * cols).sum(1)),\
                          (cols.T @ dout, cols.to(BF16).float().T @ dout):
        err = (exact - rounded).abs().max().item()
        assert err <= TOL_REL / 4 * exact.abs().max().item(), err


class _FakeLibrary:
    """Stands in for the built library: records each launch."""

    def __init__(self):
        self.calls = []
        for kernel in KERNELS:
            for name in (f"dcn_v2_bwd_{kernel}_launch", f"dcn_v2_bwd_{kernel}_bf16_launch"):
                setattr(self, name, self._launcher(name))

    def _launcher(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        launch.argtypes = launch.restype = None
        return launch


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_launches_the_bf16_body(kernel, monkeypatch):
    """bf16 operands reach the `_bf16_launch` entry point with the scratch of
    `bwd_plan(dtype=bf16)`, are counted in `launches` and `launches_bf16`,
    and the terms come back in the operands' type."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(dcn_bwd, "_declare", lambda built: built)
    monkeypatch.setattr(dcn_bwd, "_multiprocessors", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: types.SimpleNamespace(cuda_stream=None))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 9, 11, 24, generator=gen).to(BF16)
    om = torch.randn(2, 9, 11, 27, generator=gen).to(BF16)
    weight = torch.randn(3, 3, 24, 40, generator=gen).to(BF16)
    dout = torch.randn(2, 9, 11, 40, generator=gen).to(BF16)
    counter = types.SimpleNamespace(launches=0, launches_bf16=0)
    terms = dcn_bwd._launch(kernel, None if kernel == "dx" else x, om[..., :18],
                            torch.sigmoid(om[..., 18:]), weight, dout, counter=counter)
    assert counter.launches == counter.launches_bf16 == len(lib.calls) == 1
    name, args = lib.calls[0]
    assert name == f"dcn_v2_bwd_{kernel}_bf16_launch"
    assert args[10] == bwd_plan(kernel, 2, 9, 11, 24, 40, 132, BF16)["scratch_floats"]
    wants = {"fused": (0, 1, 2, 3), "dx": (0,), "dcoord": (1, 2), "dw": (3,)}[kernel]
    assert [i for i, t in enumerate(terms) if t is not None] == list(wants)
    assert all(terms[i].dtype == BF16 for i in wants)


def test_wrapper_refuses_mixed_types_before_any_build(monkeypatch):
    def no_build(name):
        raise AssertionError("built for operands the kernels do not take")

    monkeypatch.setattr(_build, "load", no_build)
    x = torch.zeros(1, 5, 6, 16, dtype=BF16)
    om = torch.zeros(1, 5, 6, 27, dtype=BF16)
    weight = torch.zeros(3, 3, 16, 16, dtype=BF16)
    dout = torch.zeros(1, 5, 6, 16, dtype=BF16)
    for bad in ("offset", "weight", "dout"):
        args = [x, om[..., :18], om[..., 18:], weight, dout]
        i = {"offset": 1, "weight": 3, "dout": 4}[bad]
        args[i] = args[i].float()
        with pytest.raises(TypeError, match="one type"):
            dcn_bwd._launch("fused", *args)
    with pytest.raises(TypeError, match="one type"):
        dcn_bwd._launch("fused", *(t.half() for t in (x, om[..., :18], om[..., 18:], weight, dout)))
