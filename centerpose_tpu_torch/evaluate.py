"""Evaluation entry point of the PyTorch package.

    python -m centerpose_tpu_torch.evaluate --mode metric --data_dir DATA --c shoe
    python -m centerpose_tpu_torch.evaluate --mode loss --data_dir DATA --load_model exp/dlav1_34/default/ckpt

The twin of the JAX package's root `evaluate.py`, with its flags, names and
defaults. Two modes (parity target: the reference's two harness entry points):
  * `--mode metric` — Objectron-style AP of the package's `Detector` over a
    DOPE-format dataset (`--data_dir`) or Objectron tfrecords
    (`--tfrecords`), image or video (`--tracking`, `--refined_kalman`,
    `--video_eval`), with the reference's ablations, cup/mug routing,
    resumable per-video stats and worker processes
    (src/tools/objectron_eval/eval_{image,video}_official.py; see
    `evaluation/evaluator.py`);
  * `--mode loss` — the validation loss of one checkpoint, or of every
    checkpoint under `--load_model` with `--all_checkpoints`
    (src/test.py:25-224), averaged over samples (the tail partial batch
    counts by its size); with `--tracking`, of the tracking model on the
    val split of its dataset (each sample with its previous frame).

Added: `--device` (default cuda; asked for cuda on a host without one, it
raises). `--dcn_impl` is accepted and ignored: this package has one DCN
kernel, which computes what every sampler of the JAX package computes.
`--load_model`, `--init_load_model` and `--mug_model` take a reference `.pth`
or a checkpoint directory of this package's `train.py`
(`utils/checkpoint.py::load_for_inference`); `--mode loss` reads checkpoint
directories (`load_checkpoint`).

Where the twin differs from the reference on purpose:
  * `--n_proc > 1` gives each worker every setting of the run. The
    reference's workers drop the CenterPose-initialisation model,
    `--eval_MobilePose_postprocessing` and `--eval_gt_scale`
    (evaluate.py:148-172, 175-214), the `--eval_continue` workers also
    `--eval_mug_symmetric` and, under `--data_dir`, the mug detector; its
    merged report's evaluator drops `--eval_num_symmetry` and
    `--eval_mug_symmetric` (:465). Here one picklable `Job` carries them all,
    in process and in every worker.
  * The mug sub-model takes `--vis_thresh` as the cup model does (the
    reference builds it at the preset's threshold, evaluate.py:228-236).
  * `--data_dir` with `--n_proc > 1` needs `--eval_continue`, where the
    reference shards its videos too; without it the reference evaluates
    them in one process and ignores `--n_proc`, and the twin refuses.
  * `--data_dir` refuses the options its driver does not run, which the
    reference ignores there: the four video ablations
    (`--eval_gt_pre_hm_first`, `--eval_add_noise`, `--eval_fake_output`,
    `--eval_CenterPose_initialization`), `--mug_model` and `--mug_only`.
    They run on `--tfrecords`.
  * An `--eval_hard_case` subset that matches no video evaluates nothing
    (the reference's `--data_dir` path then evaluates every video).

`main(argv)` returns what it printed: in metric mode `{"report":
report_dict, "evaluator": Evaluator}`, in loss mode `{"runs": [...]}` with
each checkpoint's losses, sample count and ms per batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import multiprocessing as mp
import os
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional, Tuple

import torch

from centerpose_tpu_torch.config import CenterPoseConfig, preset
from centerpose_tpu_torch.evaluation.evaluator import (
    EvalAblation,
    Evaluator,
    evaluate_dataset,
    evaluate_tfrecords,
)

# (video id, its tfrecord or None for a --data_dir video)
Video = Tuple[str, Optional[str]]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="centerpose_tpu_torch evaluation")
    p.add_argument("--mode", choices=("loss", "metric"), default="metric")
    p.add_argument("--data_dir", default="")
    p.add_argument("--c", dest="category", default="shoe")
    p.add_argument("--arch", default="dlav1_34")
    p.add_argument("--load_model", default="",
                   help="reference .pth or train.py checkpoint directory (loss mode: a directory)")
    p.add_argument("--tracking", action="store_true")
    p.add_argument("--eval_num_symmetry", type=int, default=0, help="0 = auto")
    p.add_argument("--max_images", type=int, default=0)
    p.add_argument("--report_file", default="")
    p.add_argument("--report_json", default="",
                   help="write the machine-readable AP report (per-family "
                        "report-point AP + full 21-threshold curves) as JSON")
    p.add_argument("--input_res", type=int, default=512)
    p.add_argument("--vis_thresh", type=float, default=0.0,
                   help="override the detection confidence threshold "
                        "(eval_opts.py --eval_confidence parity); tracking "
                        "eval also applies it to the track-spawn threshold. "
                        "0 = preset default (0.3)")
    p.add_argument("--dcn_impl", default="gather", choices=("gather", "onehot", "onehot_exact"),
                   help="accepted and ignored: this package has one DCN kernel, which computes "
                        "what every sampler of the JAX package computes")
    p.add_argument("--compute_dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--all_checkpoints", action="store_true",
                   help="loss mode: replay every epoch_*/best/ckpt dir under --load_model "
                        "(src/test.py parity)")
    # Video-eval ablations (shell_eval_video_CenterPoseTrack.py mode presets).
    p.add_argument("--eval_gt_pre_hm_first", action="store_true")
    p.add_argument("--eval_add_noise", action="store_true")
    p.add_argument("--eval_fake_output", action="store_true")
    p.add_argument("--eval_empty_pre_hm", action="store_true")
    p.add_argument("--eval_CenterPose_initialization", action="store_true",
                   help="seed the tracker's first frame with a CenterPose image model "
                        "(MODE_5, eval_video_official.py:392-480)")
    p.add_argument("--eval_MobilePose_postprocessing", action="store_true",
                   help="replace PnP with MobilePose EPnP 2D→3D lifting "
                        "(eval_image_official.py:805-862)")
    p.add_argument("--eval_gt_scale", action="store_true",
                   help="re-run PnP with the matched GT's scale "
                        "(predict_gt_scale, eval_image_official.py:228-241)")
    p.add_argument("--init_load_model", default="",
                   help="checkpoint for the CenterPose-initialization image model")
    p.add_argument("--no_kalman", action="store_true")
    p.add_argument("--video_eval", action="store_true",
                   help="force video-sequence eval semantics (per-video reset + "
                        "consistency over raw detections) for a plain image model — "
                        "the null config of the KF-baseline ablation")
    p.add_argument("--no_scale_pool", action="store_true")
    p.add_argument("--refined_kalman", action="store_true")
    p.add_argument("--tfrecords", default="",
                   help="evaluate Objectron tfrecords (glob) instead of --data_dir")
    p.add_argument("--stats_save", default="",
                   help="dump raw hit/conf records for scripts/group_report.py")
    p.add_argument("--eval_continue", action="store_true",
                   help="resumable eval (eval_video_official.py:1599-1602 parity): "
                        "--stats_save names a DIRECTORY; each video's raw stats are "
                        "written as <dir>/<video_id>.json and videos with an existing "
                        "stats file are skipped on restart (their records are merged "
                        "into the report). The video-consistency score is not "
                        "recomputable from merged stats and is omitted.")
    p.add_argument("--n_proc", type=int, default=1,
                   help="evaluate videos in N spawned worker processes, each with its own "
                        "detectors on --device (eval_video_official.py:1639-1675 parity); "
                        "composes with --eval_continue for killable/resumable sweeps; "
                        "--data_dir only with --eval_continue")
    p.add_argument("--eval_hard_case", type=int, default=0, choices=(0, 1, 2),
                   help="evaluate a video subset: 1 = ids from --eval_hard_case_file "
                        "(hard_cases.json: {category: [video_id, ...]}), 2 = ids from "
                        "--eval_hard_case_list (eval_video_official.py:1574-1603)")
    p.add_argument("--eval_hard_case_list", nargs="*", default=[])
    p.add_argument("--eval_hard_case_file", default="hard_cases.json")
    # Cup/mug dual-model path (eval_image_official.py:166-226,297-346).
    p.add_argument("--mug_model", default="",
                   help="category 'cup' only: checkpoint for the MUG sub-model; samples "
                        "are routed between it and --load_model (the 12-fold-symmetric "
                        "cup sub-model) by the hand relabel lists")
    p.add_argument("--label_dir", default="",
                   help="directory with the cup/mug relabel lists "
                        "(label/cup/{cup,mug_left,mug_right}_list.txt; defaults to "
                        "$CENTERPOSE_LABEL_DIR)")
    p.add_argument("--mug_only", choices=("all", "mug", "cup"), default="all",
                   help="cup category: restrict to mug-only or cup-only samples "
                        "(eval_image_official.py:336-346)")
    p.add_argument("--eval_mug_symmetric", type=int, default=1,
                   help="1 (default): mugs also get the rotation-symmetry sweep (the "
                        "Objectron-paper convention); 0: matched mugs skip the sweep")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    if not args.data_dir and not args.tfrecords:
        p.error("one of --data_dir / --tfrecords is required")
    if args.mode == "metric" and not args.tfrecords:
        tfrecord_only = [flag for flag, on in (
            ("--eval_gt_pre_hm_first", args.eval_gt_pre_hm_first),
            ("--eval_add_noise", args.eval_add_noise),
            ("--eval_fake_output", args.eval_fake_output),
            ("--eval_CenterPose_initialization", args.eval_CenterPose_initialization),
            ("--mug_model", bool(args.mug_model)),
            ("--mug_only", args.mug_only != "all"),
        ) if on]
        if tfrecord_only:
            p.error(f"{', '.join(tfrecord_only)}: run on --tfrecords only (the --data_dir "
                    "driver has no GT seeds or cup/mug labels)")
    if args.eval_continue and not args.stats_save:
        p.error("--eval_continue requires --stats_save DIR")
    if args.mode == "metric" and not args.tfrecords and args.n_proc > 1 and not args.eval_continue:
        p.error("--data_dir --n_proc > 1 requires --eval_continue (the reference evaluates "
                "--data_dir in one process otherwise)")
    return args


def _hard_case_filter(args) -> Optional[List[str]]:
    """Video-id subset for --eval_hard_case (reference parity)."""
    if args.eval_hard_case == 1:
        with open(args.eval_hard_case_file) as f:
            cases = json.load(f)
        ids = cases.get(args.category, cases if isinstance(cases, list) else [])
        return [str(v[0]) if isinstance(v, (list, tuple)) else str(v) for v in ids]
    if args.eval_hard_case == 2:
        return [str(v) for v in args.eval_hard_case_list]
    return None


def _videos(args) -> List[Video]:
    """The run's videos in order: one per tfrecord, or per --data_dir video
    directory; the --eval_hard_case subset if one is asked for."""
    if args.tfrecords:
        videos = [(os.path.splitext(os.path.basename(r))[0], r)
                  for r in sorted(glob.glob(args.tfrecords))]
    else:
        from centerpose_tpu_torch.data.dataset import find_samples

        videos = [(v, None) for v in sorted({s[1] for s in find_samples(args.data_dir)})]
    hard_ids = _hard_case_filter(args)
    if hard_ids is not None:
        keep = set(hard_ids)
        videos = [(v, r) for v, r in videos if v in keep]
    return videos


def _config(args) -> CenterPoseConfig:
    name = "centerpose_track" if args.tracking else (
        "centerpose" if args.arch.startswith("dlav1") else "centerpose_dla"
    )
    overrides = {}
    if args.vis_thresh > 0:
        overrides["vis_thresh"] = args.vis_thresh
        overrides["new_thresh"] = args.vis_thresh
    if args.eval_empty_pre_hm:
        overrides["empty_pre_hm"] = True
    if args.no_kalman:
        overrides["use_kalman"] = False
    if args.no_scale_pool:
        overrides["use_scale_pool"] = False
    if args.refined_kalman:
        overrides["refined_kalman"] = True
    return preset(
        name,
        category=args.category,
        arch=args.arch if not args.tracking else "dla_34",
        input_h=args.input_res,
        input_w=args.input_res,
        compute_dtype=args.compute_dtype,
        **overrides,
    )


@dataclasses.dataclass(frozen=True)
class Job:
    """Everything one evaluating process needs: the main process's, and what
    each spawned worker is given (so it is picklable)."""

    cfg: CenterPoseConfig
    device: str
    load_model: str
    data_dir: str
    max_images: Optional[int]
    is_video: bool
    ablation: EvalAblation
    eval_num_symmetry: Optional[int]
    mobilepose_postprocess: bool
    gt_scale: bool
    init_load_model: str
    mug_model: str
    label_dir: str
    mug_only: Optional[bool]
    eval_mug_symmetric: bool

    @classmethod
    def from_args(cls, args, cfg: CenterPoseConfig) -> "Job":
        return cls(
            cfg=cfg, device=args.device, load_model=args.load_model, data_dir=args.data_dir,
            max_images=args.max_images or None,
            # Video-sequence semantics (per-video tracker reset, consistency
            # scoring) for the Track pipeline AND the CenterPose+KF baseline.
            is_video=args.tracking or args.refined_kalman or args.video_eval,
            ablation=EvalAblation(
                gt_pre_hm_first=args.eval_gt_pre_hm_first,
                add_noise=args.eval_add_noise,
                fake_output=args.eval_fake_output,
                centerpose_init=args.eval_CenterPose_initialization,
            ),
            eval_num_symmetry=args.eval_num_symmetry or None,
            mobilepose_postprocess=args.eval_MobilePose_postprocessing,
            gt_scale=args.eval_gt_scale, init_load_model=args.init_load_model,
            mug_model=args.mug_model, label_dir=args.label_dir,
            mug_only={"all": None, "mug": True, "cup": False}[args.mug_only],
            eval_mug_symmetric=bool(args.eval_mug_symmetric),
        )

    def evaluator(self) -> Evaluator:
        return Evaluator(self.cfg, self.eval_num_symmetry, self.eval_mug_symmetric)


class Detectors:
    """The detectors of a run, built on `job.device`: the main one; the
    CenterPose image model seeding the tracker (MODE_5); and for category
    'cup' the MUG sub-model with its relabel lists
    (eval_image_official.py:166-182)."""

    def __init__(self, job: Job):
        from centerpose_tpu_torch.inference.detector import Detector

        cfg = job.cfg
        self.main = Detector(cfg, device=job.device, load_model=job.load_model)
        self.init = None
        if job.ablation.centerpose_init:
            init_cfg = preset("centerpose", category=cfg.category, input_h=cfg.input_h,
                              input_w=cfg.input_w, compute_dtype=cfg.compute_dtype)
            self.init = Detector(init_cfg, device=job.device, load_model=job.init_load_model)
        self.mug = None
        self.relabel = None
        if cfg.category == "cup":
            from centerpose_tpu_torch.evaluation.relabel import RelabelLists

            self.relabel = RelabelLists.resolve(job.label_dir or None)
            if job.mug_model:
                # The mug sub-model: same arch and thresholds, non-symmetric
                # (preset skips the 12-fold cup symmetry when mug=True).
                mug_cfg = preset(
                    "centerpose" if cfg.arch.startswith("dlav1") else "centerpose_dla",
                    category="cup", mug=True, arch=cfg.arch, input_h=cfg.input_h,
                    input_w=cfg.input_w, compute_dtype=cfg.compute_dtype,
                    vis_thresh=cfg.vis_thresh, new_thresh=cfg.new_thresh,
                )
                self.mug = Detector(mug_cfg, device=job.device, load_model=job.mug_model)


def _evaluate(job: Job, dets: Detectors, videos: List[Video]) -> Evaluator:
    """One driver call over `videos` (all tfrecords, or all --data_dir ids)."""
    if not videos:
        return job.evaluator()
    common = dict(max_images=job.max_images, is_video=job.is_video,
                  eval_num_symmetry=job.eval_num_symmetry,
                  mobilepose_postprocess=job.mobilepose_postprocess, gt_scale=job.gt_scale)
    if videos[0][1] is not None:
        return evaluate_tfrecords(
            dets.main, [r for _, r in videos], job.cfg, ablation=job.ablation,
            init_detector=dets.init, detector_mug=dets.mug, relabel=dets.relabel,
            mug_only=job.mug_only, eval_mug_symmetric=job.eval_mug_symmetric, **common,
        )
    return evaluate_dataset(dets.main, job.data_dir, job.cfg,
                            video_filter=[v for v, _ in videos], **common)


def _stats_path(stats_dir: str, video: str) -> str:
    return os.path.join(stats_dir, f"{video}.json")


def _evaluate_each(job: Job, dets: Detectors, videos: List[Video], stats_dir: str) -> None:
    """--eval_continue: one video at a time, each video's raw stats written
    atomically to <stats_dir>/<video>.json, so a killed sweep resumes after
    the last video it finished (eval_video_official.py:1599-1602)."""
    for video in videos:
        path = _stats_path(stats_dir, video[0])
        if os.path.exists(path):
            continue
        tmp = f"{path}.tmp{os.getpid()}"
        _evaluate(job, dets, [video]).save_stats(tmp)
        os.replace(tmp, path)


def _worker(job: Job, videos: List[Video], stats_dir: str, per_video: bool) -> None:
    """A spawned worker's share, on its own detectors: one stats file per
    video (--eval_continue) or one for the whole shard, in `stats_dir`."""
    dets = Detectors(job)
    if per_video:
        _evaluate_each(job, dets, videos, stats_dir)
    else:
        _evaluate(job, dets, videos).save_stats(_stats_path(stats_dir, f"shard-{videos[0][0]}"))


def _in_workers(job: Job, videos: List[Video], n_proc: int, stats_dir: str,
                per_video: bool) -> List[List[Video]]:
    """Round-robin `videos` over `n_proc` spawned workers (embarrassingly
    parallel per-video shards, eval_video_official.py:1639-1675); returns
    the shards."""
    shards = [s for s in (videos[i::n_proc] for i in range(n_proc)) if s]
    # An executor, not a Pool: a worker that dies raises here (BrokenProcessPool)
    # instead of being replaced while the parent waits for ever.
    with ProcessPoolExecutor(n_proc, mp_context=mp.get_context("spawn")) as pool:
        for future in [pool.submit(_worker, job, s, stats_dir, per_video) for s in shards]:
            future.result()
    return shards


def _metric(args, job: Job) -> Evaluator:
    videos = _videos(args)
    merged = job.evaluator()
    if args.eval_continue:
        stats_dir = args.stats_save
        os.makedirs(stats_dir, exist_ok=True)
        pending = []
        for video in videos:
            if os.path.exists(_stats_path(stats_dir, video[0])):
                print(f"eval_continue: skipping {video[0]} (stats exist)", flush=True)
            else:
                pending.append(video)
        if args.n_proc > 1 and len(pending) > 1:
            _in_workers(job, pending, args.n_proc, stats_dir, per_video=True)
        elif pending:
            _evaluate_each(job, Detectors(job), pending, stats_dir)
        for vid, _ in videos:
            if os.path.exists(_stats_path(stats_dir, vid)):
                merged.load_and_merge(_stats_path(stats_dir, vid))
        return merged
    if args.n_proc > 1 and len(videos) > 1:
        with tempfile.TemporaryDirectory() as tmp:
            for shard in _in_workers(job, videos, args.n_proc, tmp, per_video=False):
                merged.load_and_merge(_stats_path(tmp, f"shard-{shard[0][0]}"))
        return merged
    return _evaluate(job, Detectors(job), videos)


def _write(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _loss(args, cfg: CenterPoseConfig) -> dict:
    from centerpose_tpu_torch.data.dataset import ObjectPoseDataset, collate_filtered
    from centerpose_tpu_torch.models.factory import create_model
    from centerpose_tpu_torch.training.trainer import create_train_state, make_eval_step
    from centerpose_tpu_torch.utils.checkpoint import load_checkpoint

    # float32 parameters whatever --compute_dtype (a bf16 step casts at use),
    # as train.py builds the model whose checkpoints this replays.
    model = create_model(cfg, args.device, generator=torch.Generator().manual_seed(0),
                         param_dtype=cfg.param_dtype)
    state, _ = create_train_state(cfg, model)
    eval_fn = make_eval_step(cfg, model)
    ds = ObjectPoseDataset(args.data_dir, cfg, split="val")

    def run_val() -> dict:
        # Sample-count-weighted averages of the per-batch means — the
        # reference's AverageMeter semantics (base_trainer.py
        # update(loss, batch.size(0))); the tail partial batch counts by its size.
        agg, n, ms = {}, 0, []

        def flush(buf):
            nonlocal n
            batch = collate_filtered(buf)
            if batch is None:
                return
            t0 = time.perf_counter()
            stats = eval_fn(state, batch)
            keys = list(stats)
            values = torch.stack([stats[k].float() for k in keys]).tolist()   # waits for the device
            ms.append((time.perf_counter() - t0) * 1e3)
            n += len(buf)
            for k, v in zip(keys, values):
                agg[k] = agg.get(k, 0.0) + v * len(buf)

        buf = []
        for i in range(len(ds)):
            item = ds[i]
            if item is None:
                continue
            item.pop("meta", None)
            buf.append(item)
            if len(buf) == 8:
                flush(buf)
                buf = []
        if buf:
            flush(buf)
        return {"losses": {k: v / max(n, 1) for k, v in agg.items()}, "samples": n,
                "ms_per_batch": ms}

    runs = []
    if args.all_checkpoints and args.load_model:
        # test.py parity: replay every saved checkpoint through the val loss.
        dirs = sorted(d for d in glob.glob(os.path.join(args.load_model, "*")) if os.path.isdir(d))
        for d in dirs:
            try:
                _, step = load_checkpoint(d, state)
            except FileNotFoundError:
                continue
            run = {"name": os.path.basename(d), "step": step, **run_val()}
            print(f"{run['name']} (step {step}): "
                  + " ".join(f"{k}={v:.4f}" for k, v in run["losses"].items()))
            runs.append(run)
    else:
        step = None
        if args.load_model:
            _, step = load_checkpoint(args.load_model, state)
        run = {"name": args.load_model, "step": step, **run_val()}
        print(" ".join(f"{k}={v:.4f}" for k, v in run["losses"].items()))
        runs.append(run)
    return {"runs": runs}


def main(argv=None) -> dict:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device here (pass --device cpu to evaluate "
                           "on the CPU)")
    cfg = _config(args)
    if args.mode == "loss":
        return _loss(args, cfg)

    evaluator = _metric(args, Job.from_args(args, cfg))
    report = evaluator.report()
    print(report)
    report_dict = evaluator.report_dict()
    if args.report_file:
        _write(args.report_file, report + "\n")
    if args.report_json:
        _write(args.report_json, json.dumps(report_dict, indent=1))
    if args.stats_save and not args.eval_continue:
        # (with --eval_continue the per-video files under the stats dir ARE
        # the persisted stats)
        evaluator.save_stats(args.stats_save)
    return {"report": report_dict, "evaluator": evaluator}


if __name__ == "__main__":
    main()
