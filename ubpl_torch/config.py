"""Experiment configuration: the port's copy of ``ubpl_tpu/config.py``.

Same fields, defaults and ``override`` aliases (reference argparse names and
"True"/"False" coercion), so a parameter dict written for the JAX package
configures the port unchanged.

Fields that steer only the XLA/TPU lowering (``unroll_branches``,
``scan_branches``, ``scan_batches``, ``donate_state``,
``fuse_teacher_forward``, ``mesh_shape``/``mesh_axes``) are accepted and
ignored: they leave the math unchanged (the trainers still refuse
``stream_data`` with ``scan_batches > 1``, as the JAX package does).  ``io_workers`` sets the host
decode threads of ``data.arrays``.
"""
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


def parse_axis_spec(value, cast=int) -> Tuple:
    """Accept a tuple/list or a CLI string like "2,4" / "model,data"
    (copy of ``ubpl_tpu/parallel/mesh.py:parse_axis_spec``)."""
    if isinstance(value, str):
        return tuple(cast(v.strip()) for v in value.split(",") if v.strip())
    if isinstance(value, (int, float)):
        return (cast(value),)
    return tuple(cast(v) for v in value)


@dataclass
class Config:
    # Model
    model: str = "HG3"                  # HG{n} | LitePose; classification:
                                        # VGG* | ResNet* | MobileNet
    feature_mode: str = "AvgPool"       # default | MaxPool | AvgPool | ConvOne
    br_num: int = 2
    br_aug_num: int = 1
    br_gt_num: int = 1

    # Dataset
    data_source: str = "Mouse"
    train_count: int = 100
    valid_count: int = 500
    label_ratio: float = 0.3
    data_root: Optional[str] = None
    cache_dir: Optional[str] = None

    # Training strategy
    epochs: int = 100
    train_bs: int = 4
    train_bs_labeled: int = 2
    infer_bs: int = 128
    lr: float = 2.5e-4
    wd: float = 0.0                     # AdamW weight decay; passed to
                                        # torch.optim.AdamW explicitly (its
                                        # own default is 0.01)
    optimizer: str = "adamw"
    mld_alpha: float = 0.5
    power: float = 0.9

    # Augmentation
    use_flip: bool = True
    scale_range: float = 0.25
    rot_range: float = 30.0
    use_occlusion: bool = False
    num_occluder: int = 8
    scale_range_ema: float = 0.25
    rot_range_ema: float = 30.0
    use_occlusion_ema: bool = False
    num_occluder_ema: int = 8

    # Loss weights / SSL hyper-params
    pose_weight: float = 10.0
    cons_weight_max: float = 10.0
    cons_weight_min: float = 0.0
    cons_weight_rampup: int = 5
    fdl_type: str = "covariance"
    fdl_label: str = "labeled"
    fdl_weight_max: float = 1.0
    fdl_weight_min: float = 1.0
    fdl_weight_rampup: int = 100
    use_ensemble_pseudo: bool = True
    ensemble_pseudo_weight: float = 10.0
    pseudo_weight_max: float = 1.0
    pseudo_weight_min: float = 1.0
    pseudo_weight_rampup: int = 100
    pseudo_score_thr: float = 0.95
    ema_decay: float = 0.999
    pseudo_rounds: int = 0
    pseudo_interval: int = 10
    pseudo_reliable_pct: float = 0.5
    pseudo_aug_views: int = 2

    torch_init: str = ""

    # misc
    seed: int = 1388
    debug: bool = False
    profile_dir: Optional[str] = None
    experiment_root: str = field(default_factory=lambda: os.environ.get(
        "UBPL_EXPR_ROOT", "./experiments"))
    program: str = "ubpl_torch-0.1"

    # device knobs: compute_dtype and remat are read; the others steer only
    # the XLA/TPU lowering and are accepted for parameter-dict parity
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axes: Tuple[str, ...] = ("data",)
    compute_dtype: str = "bfloat16"     # bf16 autocast on the card
    donate_state: bool = True
    fold_views: bool = False
    fuse_teacher_forward: bool = False
    stream_data: bool = False
    remat: bool = False                 # torch.utils.checkpoint the training
                                        # forward (train/common.py)
    scan_batches: int = 1
    unroll_branches: Optional[bool] = None
    scan_branches: bool = False
    io_workers: int = 16                # host image-decode threads

    # synthetic data (benchmarks / smoke runs — no disk IO)
    synthetic_data: bool = False
    synthetic_kps: int = 9
    force_inp_res: Optional[int] = None
    force_out_res: Optional[int] = None

    # filled from the datasource at setup
    kps_count: int = 0
    inp_res: int = 256
    out_res: int = 64
    pck_ref: Sequence[int] = ()
    pck_thr: float = 0.5

    REFERENCE_ALIASES = {
        "dataSource": "data_source", "trainCount": "train_count",
        "validCount": "valid_count", "labelRatio": "label_ratio",
        "trainBS": "train_bs", "trainBS_labeled": "train_bs_labeled",
        "inferBS": "infer_bs", "useFlip": "use_flip",
        "scaleRange": "scale_range", "rotRange": "rot_range",
        "useOcclusion": "use_occlusion", "numOccluder": "num_occluder",
        "scaleRange_ema": "scale_range_ema", "rotRange_ema": "rot_range_ema",
        "useOcclusion_ema": "use_occlusion_ema",
        "numOccluder_ema": "num_occluder_ema",
        "poseWeight": "pose_weight",
        "consWeight_max": "cons_weight_max",
        "consWeight_min": "cons_weight_min",
        "consWeight_rampup": "cons_weight_rampup",
        "FDL_type": "fdl_type", "FDL_label": "fdl_label",
        "FDLWeight_max": "fdl_weight_max", "FDLWeight_min": "fdl_weight_min",
        "FDLWeight_rampup": "fdl_weight_rampup",
        "useEnsemblePseudo": "use_ensemble_pseudo",
        "ensemblePseudoWeight": "ensemble_pseudo_weight",
        "pseudoWeight_max": "pseudo_weight_max",
        "pseudoWeight_min": "pseudo_weight_min",
        "pseudoWeight_rampup": "pseudo_weight_rampup",
        "pseudoScoreThr": "pseudo_score_thr",
        "ema_decay": "ema_decay", "feature_mode": "feature_mode",
        "brNum": "br_num", "br_augNum": "br_aug_num", "br_gtNum": "br_gt_num",
    }

    def override(self, params: Optional[dict]):
        """Reference setArgs: dict override + "True"/"False" coercion;
        accepts both Config field names and reference argparse names."""
        if not params:
            return self
        for k, v in params.items():
            k = self.REFERENCE_ALIASES.get(k, k)
            if hasattr(self, k):
                if v == "True":
                    v = True
                elif v == "False":
                    v = False
                if k in ("mesh_shape", "mesh_axes") and v is not None:
                    v = parse_axis_spec(v, int if k == "mesh_shape" else str)
                setattr(self, k, v)
        return self

    def to_json(self, path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=str)

    @property
    def n_stack(self):
        if self.model.startswith("HG"):
            return int(self.model[2:])
        return 1
