"""Dot-FLOP parity helpers of the port's dry-run tests (not collected).

The port counts a step with ``launch.dryrun.count_cell`` (aten ops on
fake tensors, ``FlopCounterMode``); the reference lowers and compiles it
with ``repro.launch.dryrun.lower_cell`` on a one-device (1, 1) host mesh
and reads ``analyze_hlo(...).dot_flops`` from its optimized HLO.  Smoke
configs at small shapes: a train step of 4 x 64 tokens, a prefill of
2 x 64, a decode step over a 128-position cache, and (``"long_500k"`` by
name, so both packages take the kNN attention) one over 512 positions.

``RATIO`` is each family's port/reference ratio, as measured and stated
in ROADMAP's divergences; the tests hold each to it within 1e-5:
  * dense (and the embeddings input, M-RoPE): the same dots, 1.
  * MoE (granite-moe): the reference's dispatch and combine are one-hot
    einsums, counted as dots; the port gathers and scatters (no dots).
    The train step's one-hots are largest: 0.698.
  * MLA (deepseek-v2, MLA layers with MoE FFNs): the MoE one-hots again.
  * SSD (mamba2): forward equal; the reference's optimized training HLO
    has 393,216 more dot FLOPs (0.29%) than the port's autograd runs.
  * RG-LRU with local attention (recurrentgemma): equal.
  * encoder-decoder (whisper): the reference's prefill runs the encoder
    twice (``_encode`` and ``forward_prefill``), the port's once.
"""
import os

_flags = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as ref_dryrun  # noqa: E402 (it sets XLA_FLAGS)

# the reference's dry run forces 512 fake devices at import; nothing here
# runs before the flag is restored, so this process keeps its one device
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

from repro.analysis.hlo_cost import analyze_hlo  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.launch import shardspecs as ref_ss  # noqa: E402
from repro.launch.mesh import make_host_mesh as ref_host_mesh  # noqa: E402
from repro.parallel.sharding import use_mesh as ref_use_mesh  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.launch.dryrun import count_cell  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402

SHAPES = {"train": ("train", 64, 4, "train"),
          "prefill": ("prefill", 64, 2, "prefill"),
          "decode": ("decode", 128, 2, "decode"),
          "knn_decode": ("long_500k", 512, 1, "decode")}
RATIO = {
    "internlm2-1.8b-smoke": dict(train=1.0, prefill=1.0, decode=1.0, knn_decode=1.0),
    "qwen2-vl-2b-smoke": dict(train=1.0, prefill=1.0, decode=1.0),
    "granite-moe-3b-a800m-smoke": dict(train=0.698421, prefill=0.618762,
                                       decode=0.978324, knn_decode=0.996560),
    "deepseek-v2-236b-smoke": dict(train=0.803841, prefill=0.767357,
                                   decode=0.988095, knn_decode=0.998476),
    "mamba2-2.7b-smoke": dict(train=0.997090, prefill=1.0, decode=1.0),
    "recurrentgemma-9b-smoke": dict(train=1.0, prefill=1.0, decode=1.0),
    "whisper-medium-smoke": dict(train=1.0, prefill=0.768528, decode=1.0,
                                 knn_decode=1.0),
}


def cases(archs):
    return [(a, step) for a in archs for step in RATIO[a]]


def ref_dot_flops(arch: str, step: str) -> float:
    cfg, shape = ref_get_config(arch), RefShape(*SHAPES[step])
    mesh = ref_host_mesh(1)
    with ref_use_mesh(mesh, rules=ref_ss.cell_rules(cfg, shape, mesh)):
        lowered = ref_dryrun.lower_cell(cfg, shape, mesh)
    return analyze_hlo(lowered.compile().as_text()).dot_flops


def port_dot_flops(arch: str, step: str) -> float:
    mesh = make_host_mesh(1, devices=["meta"])
    return count_cell(get_config(arch), ShapeConfig(*SHAPES[step]), mesh).dot_flops


def check(arch: str, step: str) -> None:
    ours, ref = port_dot_flops(arch, step), ref_dot_flops(arch, step)
    ratio = ours / ref
    want = RATIO[arch][step]
    assert abs(ratio - want) <= 1e-5, (arch, step, ours, ref, ratio, want)
    if want == 1.0:
        assert ours == ref, (arch, step, ours, ref)
