"""Default configuration schema of the PyTorch port.

A copy of ``halo_tpu/config/defaults.py`` with the same keys and values, so
the shipped recipe YAMLs and ``-cfg PATH [KEY VALUE ...]`` overrides merge
unchanged into either package. The ``TPU`` section is kept whole for that
reason; the keys the port does not read are marked below.
"""

from .node import CfgNode as CN

_C = CN()

_C.MODEL = CN()
_C.MODEL.NAME = "deeplabv3plus_resnet101"
_C.MODEL.NUM_CLASSES = 19
_C.MODEL.WEIGHTS = "https://download.pytorch.org/models/resnet101-5d3b4d8f.pth"
_C.MODEL.FREEZE_BN = True
_C.MODEL.HYPER = True
_C.MODEL.CURVATURE = 1.0
_C.MODEL.REDUCED_CHANNELS = 64
_C.MODEL.HFR = True

_C.WANDB = CN()
_C.WANDB.ENABLE = False
_C.WANDB.GROUP = "deeplabv2_r101_pretrain"
_C.WANDB.PROJECT = "active_domain_adapt"
_C.WANDB.ENTITY = "pinlab-sapienza"

_C.INPUT = CN()
_C.INPUT.SOURCE_INPUT_SIZE_TRAIN = (1280, 720)
_C.INPUT.TARGET_INPUT_SIZE_TRAIN = (1280, 640)
_C.INPUT.INPUT_SIZE_TEST = (1280, 640)
_C.INPUT.INPUT_SCALES_TRAIN = (1.0, 1.0)
_C.INPUT.IGNORE_LABEL = 255
_C.INPUT.PIXEL_MEAN = [0.485, 0.456, 0.406]
_C.INPUT.PIXEL_STD = [0.229, 0.224, 0.225]
# Convert image to BGR format (for Caffe2 models), in range 0-255
_C.INPUT.TO_BGR255 = False

_C.DATASETS = CN()
_C.DATASETS.SOURCE_TRAIN = ""
_C.DATASETS.TARGET_TRAIN = ""
_C.DATASETS.TEST = ""

_C.SOLVER = CN()
# Reference semantics: the list of data-parallel devices; per-rank iteration
# counts scale by len(GPUS) (reference: core/train_learners.py:181). On TPU
# this is the list of mesh data-axis indices; len(SOLVER.GPUS) = #chips.
_C.SOLVER.GPUS = [0, 1, 2, 3]
_C.SOLVER.NUM_ITER = 60000

_C.SOLVER.LR_METHOD = "poly"
_C.SOLVER.BASE_LR = 1e-3
_C.SOLVER.LR_POWER = 0.5
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.WEIGHT_DECAY = 0.0005
_C.SOLVER.WARMUP_ITERS = 600

_C.SOLVER.BATCH_SIZE = 2
_C.SOLVER.BATCH_SIZE_VAL = 1

_C.SOLVER.CONSISTENT_LOSS = 0.0
_C.SOLVER.NEGATIVE_LOSS = 1.0
_C.SOLVER.NEGATIVE_THRESHOLD = 0.05

_C.SOLVER.LCR_TYPE = "l1"

_C.ACTIVE = CN()
_C.ACTIVE.UNCERTAINTY = "entropy"
_C.ACTIVE.PURITY = "hyper"
_C.ACTIVE.SELECT_ITER = [0, 15000, 30000, 40000, 50000]
_C.ACTIVE.BUDGET = 0.05
_C.ACTIVE.RADIUS_K = 1
_C.ACTIVE.NORMALIZE = True
_C.ACTIVE.MASK_RADIUS_K = 5
_C.ACTIVE.K = 100
_C.ACTIVE.VIZ_MASK = False

_C.TEST = CN()
_C.TEST.BATCH_SIZE = 1
# Schema-compatibility key: the reference defines TEST.VIZ_SCORE but never
# reads it (reference: core/configs/defaults.py:87, no consumer); kept so
# the reference's test.yaml recipes merge cleanly.
_C.TEST.VIZ_SCORE = False
_C.TEST.VIZ_WRONG = False
_C.TEST.SAVE_EMBED = False

_C.NAME = "debug"
_C.OUTPUT_DIR = ""
_C.resume = ""
_C.SEED = -1
_C.DEBUG = False
_C.PROTOCOL = "source_target"

# ---------------------------------------------------------------------------
# TPU-native additions (absent from the reference; defaults keep behavior
# identical to the reference recipes unless explicitly overridden).
# ---------------------------------------------------------------------------
_C.TPU = CN()
# In the PyTorch port, TPU.PALLAS_SELECTION, STENCIL_TRAIN, CONV_WGRAD
# and FUSED_UPSAMPLE have no effect: greedy selection
# always runs the CUDA kernel on a GPU (active/cuda_select.py), the weight
# gradient of a cuDNN conv is cuDNN's, and the acquisition round always
# folds the upsample into the score. DENSE_CONV_MODE "pallas" routes the
# trunk's eligible dilated 3x3 convs to kernel C; its other values keep
# cuDNN. The keys stay in the schema so the same YAMLs load in both
# packages.
# Compute dtype for the backbone/classifier ("bfloat16" or "float32").
_C.TPU.COMPUTE_DTYPE = "bfloat16"
# Hyperbolic-head compute dtype. The reference runs the Poincare head in
# float64 (reference: core/models/classifier.py:553-554); TPUs emulate f64
# slowly, so the default is float32 with f32 accumulations (validated against
# an x64 golden path in tests).
_C.TPU.HYPER_DTYPE = "float32"
# Mesh axis sizes: data parallelism over ICI. -1 = use all local devices.
_C.TPU.DATA_PARALLEL = -1
# Spatial model parallelism for the acquisition scoring map (rarely needed).
_C.TPU.SPATIAL_PARALLEL = 1
# Dtype of the native-resolution logits/embedding maps fed to acquisition
# scoring. "bfloat16" (default) halves the bytes the bandwidth-bound score
# chain moves; accumulations (softmax, entropy sums, norms, min-max) stay
# float32.
# Set "float32" for bit-reproducible score maps; the selected masks differ
# only where scores are within bf16 rounding of each other (the score is
# a sampling heuristic — see tests/test_active.py bf16 agreement test).
_C.TPU.SCORING_DTYPE = "bfloat16"
# JAX package: greedy selection as its Pallas kernel. The port always runs
# kernel A on a GPU.
_C.TPU.PALLAS_SELECTION = True
# Host data-loader worker threads.
_C.TPU.LOADER_WORKERS = 4
# Input pipeline backend: "threads" (built-in prefetching loader) or
# "grain" (multiprocess Grain DataLoader; identical sample streams).
_C.TPU.LOADER = "threads"
# Rematerialize backbone blocks in backward (more FLOPs, much less
# activation memory -> larger per-chip batches). In the port each
# Bottleneck runs under torch.utils.checkpoint; live BatchNorm running
# statistics are updated once, as without it.
_C.TPU.REMAT = False
# Shifted-MAC depthwise stencil in TRAIN mode (custom VJP, layers.py:
# depthwise_stencil). Eval always uses the stencil; False reverts
# training to XLA's grouped-conv path.
_C.TPU.STENCIL_TRAIN = True
# Implementation of the trunk's dense stride-1 dilated 3x3 convs. In the
# port: "pallas" runs them through kernel C (ops/dilated_conv.py, a CUDA
# implicit GEMM, forward and input gradient) wherever the rule of
# models/layers.py:dilated_conv_eligible holds; "conv" (the default) and
# the JAX package's other lowerings ("shift9", "s2b") use cuDNN. Every
# value computes the same convolution.
_C.TPU.DENSE_CONV_MODE = "conv"
# Fold the acquisition sweep's native-res upsample into the score stage
# (fused_upsample_region_score): the (H, W, C) native logits/embedding
# never materialize in HBM (~700 MB/image saved); score maps agree with
# the materializing path to f32 ULP and greedy masks bit-for-bit
# (tests/test_active.py). False reverts to resize-then-score (reference
# structure, build.py:122-144).
_C.TPU.FUSED_UPSAMPLE = True
# JAX package: the weight-gradient lowering of its dense stride-1 convs
# ("gemm" shifted GEMMs or "conv" autodiff). No effect in the port.
_C.TPU.CONV_WGRAD = "gemm"
# Images per device dispatch during acquisition scoring (the reference
# sweeps batch=1, core/train_learners.py:282-289; any value yields
# identical masks). Every image in one dispatch must share a native
# resolution; for mixed-resolution active sets the active loader groups
# batches by size automatically at any ACTIVE_BATCH (in the port
# data/build.py:SizeGroupedBatches, in the same order as the JAX loader),
# so no manual fallback to 1 is needed.
# Post-training int8 (W8A8) evaluation: builds the model with int8 layers
# (models/layers.py:quant_eligible: the ungrouped stride-1 convs, strided
# ones on inputs of at least 128 channels, dense layers of at least 128
# input channels; the stem, depthwise convs and the logits/embedding
# producers stay float), which need a calibration pass (ops/quant.py)
# before they evaluate. It changes numerics (per-tensor activation and
# per-channel weight symmetric quantization). In the port every quantised
# layer (k x k and 1x1 convs, dense layers) runs two kernels: the
# activation quantise (csrc/int8_quant.cu), then the int8 conv
# (csrc/int8_conv.cu); a quantised build never runs kernel C.
_C.TPU.QUANT_EVAL = False
# Calibration batches fed through the model to set the PTQ activation
# absmax (TestLearner._calibrate_quant) before a QUANT_EVAL eval, and the
# int8 sweep's twin before every round. TestLearner draws them from the
# target train split under the test transform (DATASETS.TARGET_TRAIN, or
# the train split of DATASETS.TEST when that is empty; never the eval
# split being scored: the port raises where that split cannot be read).
_C.TPU.QUANT_CALIB_BATCHES = 2
# Force recalibration even when the restored checkpoint already carries
# calibrated PTQ scales (default: restored calibration is kept).
_C.TPU.QUANT_RECALIBRATE = False
# Run the acquisition sweep's eval forward through the int8 W8A8 path: an
# int8 twin of the model (built once) takes the training model's weights
# and is recalibrated on the round's first QUANT_CALIB_BATCHES sweep
# batches before every round; the selection may change. Training keeps
# the float path (and kernel C under DENSE_CONV_MODE "pallas").
_C.TPU.QUANT_SWEEP = False
# In-training validation cadence in steps (the reference hardcodes
# Lightning's val_check_interval=500, train.py:135); 0 disables.
_C.TPU.VAL_INTERVAL = 500
_C.TPU.ACTIVE_BATCH = 4
# Directory with dataset roots (reference hardcodes "datasets"; the catalog
# also honors the HALO_DATASET_DIR environment variable).
_C.TPU.DATASET_DIR = "datasets"
# Delete SAVE_DIR/gtMask + gtIndicator after training like the reference
# (reference train.py:147-162). Default False: the mask store is the
# acquisition state, and keeping it makes a preempted/crashed run
# resumable (docs/PARITY.md documents the delta).
_C.TPU.CLEANUP_MASKS = False
