"""Training throughput: the port's `make_train_step` (forward in train mode,
loss, backward, global-norm clip, Adam) on batches kept on the device, no
loader in the window.

Set-up builds one model, optimizer and step from the seed's weights, drives
it through its first three steps on three different batches (the readings
the reference is held to: each step's loss, the first gradient as the
optimizer got it, from Adam's first moment after one step, and each
parameter's change after three), and hands that same step to the window.

Traffic parameters: `batches` distinct batches made at set-up (the window
cycles them), `low_hw` (the smoothness of the images), `box_px` (the width
of the weights' boxes, output pixels), `profile_steps` (the traced segment),
`limits` per configuration. The configuration gives the
batch size, the type, the learning rate, the clip and the TF32 switches.

End-to-end: `train_images_per_s` (images of the steps completed in the
window, which ends with a synchronisation, over the window), `setup_s`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from posebench import flops, weights
from posebench.harness import Cell, Result, exact_float32
from posebench.reference import net as refnet
from posebench.reference import train as reftrain
from posebench.trace import profile
from posebench import checks

CHECKED_STEPS = 3
FLAT_GRAD = 1e-3          # leaves whose reference gradient is under this x the median leaf's


def port_step(cell: Cell, state, device):
    from centerpose_tpu_torch.config import preset
    from centerpose_tpu_torch.models.convert import load_reference_state_dict
    from centerpose_tpu_torch.models.factory import create_model
    from centerpose_tpu_torch.training.trainer import create_train_state, make_train_step

    c = cell.config
    cfg = preset(c["preset"], category=c["category"], input_h=c["input_h"], input_w=c["input_w"],
                 compute_dtype=c["train_dtype"], batch_size=c["train_batch_size"], lr=c["train_lr"],
                 grad_clip_norm=c["train_grad_clip_norm"])
    model = create_model(cfg, device, param_dtype="float32")
    load_reference_state_dict(model, state)
    train_state, tx = create_train_state(cfg, model)
    return model, tx, train_state, make_train_step(cfg, model, tx)


def plant(step, tx, fault):
    """Tests only: break the timed path underneath the window."""
    if fault == "unchanged":                     # a step that leaves the state as it was
        tx.step = lambda: torch.zeros(())
        return step
    if fault == "half_batch":                    # half of the batch left out, the mean over the rest
        return lambda st, batch: step(st, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    if fault is not None:
        raise ValueError(fault)
    return step


def leaf_norms(tensors) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def run(cell: Cell, t_process: float) -> Result:
    c, t = cell.config, cell.traffic
    device = torch.device(cell.device)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cudnn.allow_tf32 = bool(c["cudnn_tf32"])
        torch.backends.cuda.matmul.allow_tf32 = bool(c["matmul_tf32"])
        torch.cuda.reset_peak_memory_stats(device)
    spec = refnet.spec_of(c)
    bsz = int(c["train_batch_size"])
    state = weights.make_state(spec, cell.seed, device, c["input_w"], c["input_w"] // c["down_ratio"], t["box_px"])
    batches = reftrain.make_batches(cell.seed, int(t["batches"]), bsz, (c["input_h"], c["input_w"]),
                                    c["down_ratio"], t["low_hw"], device)
    model, tx, train_state, step = port_step(cell, state, device)
    step = plant(step, tx, cell.fault)
    names = {p: n for n, p in model.named_parameters()}

    losses = []
    first_grad = None
    for k in range(CHECKED_STEPS):
        train_state, stats = step(train_state, batches[k])
        losses.append(stats["loss"])
        if k == 0:
            terms1 = {n: float(v) for n, v in stats.items() if n.endswith("_loss")}
            first_grad = {names[p]: (tx.adam.state[p]["exp_avg"] / 0.1 if p in tx.adam.state
                                     else torch.zeros_like(p)) for p in tx.params}
            first_grad = leaf_norms(first_grad)
    change = leaf_norms({n: p.detach() - state[n] for n, p in model.named_parameters()})
    losses = [float(v) for v in losses]
    if cuda:
        torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    setup_s = t0 - t_process
    n_steps = 0
    while time.perf_counter() - t0 < cell.seconds:
        train_state, _ = step(train_state, batches[(CHECKED_STEPS + n_steps) % len(batches)])
        n_steps += 1
    if cuda:
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    work, dcn_calls = flops.network_work(spec, (c["input_h"], c["input_w"]))
    counters = {"images_per_s": n_steps * bsz / window_s, "network_flops_per_image": work,
                "dcn_calls": dcn_calls, "batch": bsz, "dtype": c["train_dtype"], "steps": n_steps}
    trace = None
    if cell.trace:
        n_prof = int(t["profile_steps"])

        def segment():
            st = train_state
            for k in range(n_prof):
                st, _ = step(st, batches[k % len(batches)])
        trace = profile(segment)
        counters["profiled_steps"] = n_prof

    # ---- the window is closed: the program's state goes, then the reference.
    del model, tx, train_state, step, names
    if cuda:
        torch.cuda.empty_cache()
    numbers = compare_steps(cell, state, batches[:CHECKED_STEPS], (losses, terms1, first_grad, change), device)
    verdicts = checks.judge(numbers, t["limits"][c["name"]])
    return Result(attempted=n_steps, failed=0,
                  end_to_end={"train_images_per_s": n_steps * bsz / window_s, "setup_s": setup_s},
                  counters=counters, checks=verdicts, memory_peak_bytes=int(memory_peak), trace=trace,
                  numbers=numbers)


def reference_readings(cell: Cell, state, batches, device, autocast_bf16=False):
    """(losses, first step's loss terms, first gradient's and change's norms
    by leaf) of the reference's steps."""
    c = cell.config
    net = refnet.build(refnet.spec_of(c), device, state)
    with exact_float32():
        losses, terms1, first, final = reftrain.steps(net, batches, c["train_lr"], c["train_grad_clip_norm"],
                                                      autocast_bf16=autocast_bf16)
    change = leaf_norms({k: v - state[k] for k, v in final.items()})
    return losses, terms1, leaf_norms(first), change


def compare_steps(cell: Cell, state, batches, readings, device) -> dict:
    return numbers_of(readings, reference_readings(cell, state, batches, device))


def numbers_of(prog, ref) -> dict:
    """`prog` and `ref`: (losses, first step's loss terms, first gradient's
    norms, change's norms by leaf). `loss_gap`: the worst step's |loss -
    reference| / |reference|; `grad_gap`: the worst leaf's first gradient
    norm; `change_gap`: the worst leaf's change over the checked steps,
    leaves whose reference gradient is nought to rounding (under
    `FLAT_GRAD` x the median leaf's) left out. Beside them, to say where a
    gap comes from: `loss1_gap` and `term1_gap` (the first step's loss, its
    worst term), `grad_gap_median`, `change_gap_median` (the median leaf's)
    and the worst leaves."""
    losses, terms1, grad, change = prog
    r_losses, r_terms1, r_grad, r_change = ref
    keys = sorted(r_grad)
    g_med = float(np.median([r_grad[k] for k in keys]))
    moving = [k for k in keys if r_grad[k] >= FLAT_GRAD * g_med]
    c_med = float(np.median([r_change[k] for k in moving]))
    grad_gaps = {k: abs(grad[k] - r_grad[k]) / max(r_grad[k], g_med, 1e-30) for k in keys}
    change_gaps = {k: abs(change[k] - r_change[k]) / max(r_change[k], c_med, 1e-30) for k in moving}
    worst = max(grad_gaps, key=grad_gaps.get)
    return {"loss_gap": float(max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))),
            "grad_gap": float(grad_gaps[worst]),
            "change_gap": float(max(change_gaps.values())),
            "loss1_gap": float(abs(losses[0] - r_losses[0]) / abs(r_losses[0])),
            "term1_gap": float(max(abs(terms1[k] - v) / max(abs(v), 1e-12) for k, v in r_terms1.items())),
            "grad_gap_median": float(np.median(list(grad_gaps.values()))),
            "change_gap_median": float(np.median(list(change_gaps.values()))),
            "worst_grad_leaf": worst, "worst_grad_leaf_norm": r_grad[worst], "median_grad_norm": g_med,
            "worst_change_leaf": max(change_gaps, key=change_gaps.get),
            "grad_gap_top": sorted(((round(v, 4), k) for k, v in grad_gaps.items()), reverse=True)[:8]}
