"""Typed configuration for centerpose_tpu_torch (the PyTorch/CUDA package).

The package's own copy of the JAX package's `centerpose_tpu/config.py`: same
constants, same field names and defaults, same `preset` names, so a config
written for one package reads the same in the other. Six fields of the JAX
config are NOT here because they only select TPU shapings that this package
does not have: `dcn_impl`, `dcn_window_radius` (which Pallas sampler runs),
`remat_dcn`, `dcn_bwd`, `remat_stem` (gradient-checkpointing and backward
selection for one TPU's memory) and `s2d_stem` (space-to-depth stem layout).
Here the deformable convolution has one implementation per device (the CUDA
kernel on a CUDA tensor, the plain version on a CPU tensor) and no knob.

Replaces the reference's argparse god-object (`src/lib/opts.py:14-502`) with a frozen
dataclass. `heads` is derived exactly like the reference's
`opts.update_dataset_info_and_set_heads` (`src/lib/opts.py:378-429`): the head dict is
the single source of truth for the network's output structure.

Presets mirror the five BASELINE configs plus the two training entry points
(`src/main_CenterPose.py:126-189`, `src/main_CenterPoseTrack.py:118-242`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

# Objectron categories supported by the reference (README.md:61).
CATEGORIES = (
    "bike", "book", "bottle", "camera", "cereal_box",
    "chair", "cup", "laptop", "shoe",
)

# Categories trained with N-fold rotational symmetry about the object's y axis
# (`src/main_CenterPose.py:150-156`: bottle/cup use --num_symmetry 12).
SYMMETRIC_CATEGORIES = ("bottle", "cup")

# Per-category std balance coefficient used when converting predicted log-variance
# to std at decode time (`src/lib/opts.py` --balance_coefficient defaults; decode.py:309).
DEFAULT_BALANCE_COEFFICIENT: Mapping[str, float] = {c: 2.0 for c in CATEGORIES}

# ImageNet-style input normalization (`src/lib/opts.py:438-440`).
DATA_MEAN = (0.408, 0.447, 0.470)
DATA_STD = (0.289, 0.274, 0.278)

# Horizontal-flip keypoint index pairs, 1-indexed over the 9-point cuboid
# (`src/lib/opts.py:442`).
FLIP_IDX = ((1, 5), (3, 7), (2, 6), (4, 8))

NUM_JOINTS = 8  # cuboid corners; center is implicit

# Per-category dimension statistics (means row 0, stds row 1): columns are
# [w, h, d, w/h, d/h]. Embedded dataset metadata from the reference
# (`src/lib/opts.py:443-489`) — drives the `use_residual` scale representation
# where the 'scale' head predicts log-residuals against the category mean
# (`src/lib/models/losses.py:165-172`). The mug row exists because cup splits
# into cup/mug sub-models (`opts.py:411`).
DIMENSION_REF: Mapping[str, Tuple[Tuple[float, ...], Tuple[float, ...]]] = {
    "bike": (
        (0.65320896, 1.021797894, 1.519635599, 0.6520559199, 1.506392621),
        (0.1179380561, 0.176747817, 0.2981715678, 0.1667947895, 0.3830536275),
    ),
    "book": (
        (0.225618019, 0.03949624326, 0.1625821624, 7.021850281, 5.064694187),
        (0.1687487664, 0.07391230822, 0.06436673199, 3.59629568, 2.723290812),
    ),
    "bottle": (
        (0.07889784977450116, 0.24127451915330908, 0.0723714257114412,
         0.33644069262302545, 0.3091134992864717),
        (0.02984649578071775, 0.06381390122918497, 0.03088144838560917,
         0.11052240441921059, 0.13327627592012867),
    ),
    "camera": (
        (0.11989848700326843, 0.08226238775595619, 0.09871718158089632,
         1.507216484439368, 1.1569407159290284),
        (0.021177290310316968, 0.02158788017191602, 0.055673710278419844,
         0.28789183678046854, 0.5342094080365904),
    ),
    "cereal_box": (
        (0.19202754401417296, 0.2593114001714919, 0.07723794925413519,
         0.7542602699204104, 0.29441151268928173),
        (0.08481640897407464, 0.09999915952084068, 0.09495429981036707,
         0.19829004029411457, 0.2744797990483879),
    ),
    "chair": (
        (0.5740664085137888, 0.8434027515832329, 0.6051523831888338,
         0.6949691013776601, 0.7326891354260606),
        (0.12853104253707456, 0.14852086453095492, 0.13428881418587957,
         0.16897092539619352, 0.18636134566748525),
    ),
    "cup": (
        (0.08587637391801063, 0.12025228955138188, 0.08486836104868696,
         0.7812126934904675, 0.7697895244331658),
        (0.05886805978497525, 0.06794896438246326, 0.05875681990718713,
         0.2887038681446475, 0.283821205157399),
    ),
    "mug": (
        (0.14799136566553112, 0.09729087667918128, 0.08845449667169905,
         1.3875694883045138, 1.0224997119392225),
        (1.0488828523223728, 0.2552672927963539, 0.039095350310480705,
         0.3947832854104711, 0.31089415283872546),
    ),
    "laptop": (
        (0.33685059747485196, 0.1528068814247063, 0.2781020624738614,
         35.920214652427696, 23.941173992376903),
        (0.03529983948867832, 0.07017080198389423, 0.0665823136876069,
         391.915687801732, 254.21325950495455),
    ),
    "shoe": (
        (0.10308848289662519, 0.10932616184503478, 0.2611737789760352,
         1.0301976264129833, 2.6157393112424328),
        (0.02274768925924402, 0.044958380226590516, 0.04589720205423542,
         0.3271000267177176, 0.8460337534776092),
    ),
}


@dataclasses.dataclass(frozen=True)
class CenterPoseConfig:
    # --- model -----------------------------------------------------------------
    arch: str = "dlav1_34"            # dla_34 | dlav1_34 | dlav0_34 | res_18.. | hourglass
    head_conv: int = 256
    down_ratio: int = 4
    input_h: int = 512
    input_w: int = 512
    num_classes: int = 1

    # --- head toggles (mirrors opts.py:394-427) ---------------------------------
    reg_offset: bool = True           # 'reg' head (2)
    hm_hp: bool = True                # 'hm_hp' head (8)
    reg_hp_offset: bool = True        # 'hp_offset' head (2)
    obj_scale: bool = True            # 'scale' head (3)
    obj_scale_uncertainty: bool = False
    hps_uncertainty: bool = False
    tracking: bool = False            # 'tracking' head (2)
    tracking_hp: bool = False         # 'tracking_hp' head (16)
    reg_bbox: bool = True             # 'wh' head (2)

    # --- task ------------------------------------------------------------------
    category: str = "shoe"
    num_symmetry: int = 1             # 12 for bottle/cup training
    # Cup splits into cup/mug sub-models (README.md:61): mug=True trains/serves
    # the non-symmetric mug sub-category — it selects the mug samples in the
    # dataset (dataset_combined.py:568-569), disables the 12-fold cup symmetry
    # (dataset_combined.py:361), and switches dimension_ref to the mug row
    # (opts.py:411). Evaluation of category 'cup' runs BOTH sub-models and
    # routes per sample (eval_image_official.py:166-226; evaluate.py --mug_model).
    mug: bool = False
    # Residual scale representation (opts.py:408-420 + losses.py:165-172):
    # the 'scale' head predicts log-residuals against the per-category mean
    # (DIMENSION_REF); the loss decodes pred = exp(pred) * dimension_ref.
    use_residual: bool = False
    use_absolute_scale: bool = False  # absolute [w,h,d] ref vs height-relative
    tracking_task: bool = False       # CenterPoseTrack (pre_img/pre_hm/pre_hm_hp stems)

    # --- decode / inference ------------------------------------------------------
    K: int = 100                      # top-K centers (opts.py --K)
    rep_mode: int = 1                 # keypoint representation mode (opts.py:211-220)
    test_scales: Tuple[float, ...] = (1.0,)  # multi-scale testing (opts.py --test_scales)
    # Test-time resolution policy (base_detector.py:91-148, opts.py:124-128,337):
    #   fix_short > 0  — resize the short side to fix_short, long side rounded up
    #                    to a multiple of 64;
    #   fix_res=True   — warp-crop to (input_h, input_w) (the usual mode);
    #   fix_res=False  — keep resolution, pad each side to (dim | pad) + 1.
    # Non-fixed modes give input shapes that vary with the image — use
    # fix_res for steady-state serving.
    fix_res: bool = True
    fix_short: int = -1
    vis_thresh: float = 0.3
    hm_hp_thresh: float = 0.1         # decode.py:117 `thresh`
    nms: bool = True                  # soft-NMS in merge_outputs
    balance_coefficient: float = 2.0  # per-category std scaling (opts.py:239-241)
    max_dets: int = 16                # fixed-size post-NMS detection slots

    # --- loss weights (opts.py train block defaults) -----------------------------
    hm_weight: float = 1.0
    wh_weight: float = 0.1
    off_weight: float = 1.0
    hp_weight: float = 1.0
    hm_hp_weight: float = 1.0
    obj_scale_weight: float = 1.0
    tracking_weight: float = 1.0
    tracking_hp_weight: float = 1.0
    kl_scale_uncertainty: float = 0.01   # opt.KL_scale_uncertainty
    kl_kps_uncertainty: float = 0.01     # opt.KL_kps_uncertainty

    # --- training ----------------------------------------------------------------
    lr: float = 1.25e-4
    lr_step: Tuple[int, ...] = (90, 120)
    num_epochs: int = 140
    batch_size: int = 32
    max_objs: int = 10                # reference dataset_combined.py max_objs
    grad_clip_norm: float = 100.0     # base_trainer.py:94-97
    seed: int = 317

    # --- tracking-time filtering --------------------------------------------------
    new_thresh: float = 0.3
    track_thresh: float = 0.3
    max_age: int = 5                  # opts.py:300
    kf_r_velocity: float = 20.0       # opts.py:246 --R
    use_kalman: bool = True
    use_scale_pool: bool = True
    use_hungarian: bool = False
    conf_border: Tuple[float, float] = (3.0, 9.0)  # opts.py:242-244
    refined_kalman: bool = False      # CenterPose + KF baseline (tracker_baseline.py)
    empty_pre_hm: bool = False        # eval ablation: zero previous heatmaps
    max_tracks: int = 16              # fixed track slots

    # --- system -------------------------------------------------------------------
    compute_dtype: str = "float32"    # bfloat16 for production inference
    param_dtype: str = "float32"

    # ------------------------------------------------------------------------------
    @property
    def output_h(self) -> int:
        return self.input_h // self.down_ratio

    @property
    def output_w(self) -> int:
        return self.input_w // self.down_ratio

    @property
    def num_joints(self) -> int:
        return NUM_JOINTS

    @property
    def pad(self) -> int:
        # Keep-resolution padding granularity (opts.py:346): hourglass needs
        # 128-aligned inputs for its 5-level pyramid, others 32-aligned.
        return 127 if "hourglass" in self.arch else 31

    @property
    def dimension_ref(self) -> Optional[Tuple[float, float, float]]:
        """Residual-scale reference dims, or None when use_residual is off.

        Mirrors opts.py:408-420: cup+mug uses the mug statistics; absolute
        mode returns the mean [w, h, d], relative mode [w/h, 1, d/h].
        """
        if not self.use_residual:
            return None
        key = "mug" if (self.category == "cup" and self.mug) else self.category
        means = DIMENSION_REF[key][0]
        if self.use_absolute_scale:
            return (means[0], means[1], means[2])
        return (means[3], 1.0, means[4])

    @property
    def use_conv_gru(self) -> bool:
        # dlav1 == DLA + DCN + convGRU chained heads (the 'dlav1' model-factory
        # entry is the ONLY one that passes use_convGRU=True —
        # model.py:16-25, pose_dla_dcn.py:573-590). The shipped
        # CenterPoseTrack config is dla_34 + tracking_task WITHOUT convGRU
        # (main_CenterPoseTrack.py:126); the 4-step GRU with tracking-head
        # routing exists only behind dlav1+tracking (pose_dla_dcn.py:473-477,
        # 545-556, marked "Todo: We have not tried this idea yet") and is
        # preserved here for that combination.
        return self.arch.startswith("dlav1")

    @property
    def gru_steps(self) -> int:
        return 4 if self.tracking_task else 3

    @property
    def heads(self) -> Dict[str, int]:
        """Head-name → channel-count dict; mirrors opts.py:394-427 ordering."""
        heads = {"hm": self.num_classes, "wh": 2, "hps": 2 * NUM_JOINTS}
        if self.hps_uncertainty:
            heads["hps_uncertainty"] = 2 * NUM_JOINTS
        if self.reg_offset:
            heads["reg"] = 2
        if self.hm_hp:
            heads["hm_hp"] = NUM_JOINTS
        if self.reg_hp_offset:
            heads["hp_offset"] = 2
        if self.obj_scale:
            heads["scale"] = 3
            if self.obj_scale_uncertainty:
                heads["scale_uncertainty"] = 3
        if self.tracking:
            heads["tracking"] = 2
        if self.tracking_hp:
            heads["tracking_hp"] = 2 * NUM_JOINTS
        return heads

    def replace(self, **kw) -> "CenterPoseConfig":
        return dataclasses.replace(self, **kw)


def preset(name: str, **overrides) -> CenterPoseConfig:
    """Named presets for the BASELINE configs.

    - 'centerpose':       image model, dlav1_34 + convGRU (main_CenterPose.py defaults)
    - 'centerpose_dla':   plain dla_34 + DCN, no convGRU (camera/chair released models)
    - 'centerpose_track': CenterPoseTrack video model (main_CenterPoseTrack.py:118-242)
    """
    if name == "centerpose":
        cfg = CenterPoseConfig(arch="dlav1_34")
    elif name == "centerpose_dla":
        cfg = CenterPoseConfig(arch="dla_34")
    elif name == "centerpose_track":
        cfg = CenterPoseConfig(
            arch="dla_34",
            tracking_task=True,
            tracking=True,
            tracking_hp=True,
            hps_uncertainty=True,
            obj_scale_uncertainty=True,
            num_epochs=15,
            lr_step=(6, 10),
        )
    else:
        raise ValueError(f"unknown preset: {name!r}")
    # Symmetric categories train with 12-fold rotational GT symmetry — except
    # the mug sub-model of cup, which is NOT symmetric (dataset_combined.py:361:
    # the symmetry block requires `c == 'cup' and mug == False`).
    if (
        overrides.get("category") in SYMMETRIC_CATEGORIES
        and "num_symmetry" not in overrides
        and not overrides.get("mug", False)
    ):
        overrides["num_symmetry"] = 12
    return cfg.replace(**overrides)
