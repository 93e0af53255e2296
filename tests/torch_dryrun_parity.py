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

import numpy as np

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


# -- rank 0 of a process mesh against the reference's per-device program -------

# the meshes of 4 devices: (data, model)
MESHES = ((4, 1), (2, 2), (1, 4))


def mesh_config(module, arch: str, override=None):
    """``arch`` of ``module``'s registry (the reference's or the port's)
    with the fields of ``override`` replaced, alike in both packages."""
    import dataclasses

    cfg = module.get_config(arch)
    return dataclasses.replace(cfg, **override) if override else cfg


def ref_mesh_run(cases):
    """In a child on 4 fake devices: each case ``(arch, override)``'s
    smoke train step lowered on a (d, m) host mesh of each of
    :data:`MESHES` and compiled; its per-device dot FLOPs
    (``analyze_hlo``) and collectives (``collective_bytes``: wire bytes
    by kind), by ``(key, mesh)``."""
    import jax

    import repro.configs as rc
    from repro.analysis.hlo import collective_bytes as ref_collectives

    out = {}
    for key, (arch, override) in cases.items():
        cfg, shape = mesh_config(rc, arch, override), RefShape(*SHAPES["train"])
        for dims in MESHES:
            devices = np.array(jax.devices()[:4]).reshape(dims)
            mesh = jax.sharding.Mesh(devices, ("data", "model"),
                                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
            with ref_use_mesh(mesh, rules=ref_ss.cell_rules(cfg, shape, mesh)):
                hlo = ref_dryrun.lower_cell(cfg, shape, mesh).compile().as_text()
            out[key, dims] = dict(dot_flops=analyze_hlo(hlo).dot_flops,
                                  collectives=ref_collectives(hlo)[1])
    return out


_MESH_CHILD = """
import sys
sys.path.insert(0, "tests")
import torch_dryrun_parity
publish(torch_dryrun_parity.ref_mesh_run(@CASES@))
"""


def ref_mesh_counts(cases, parts: int = 3):
    """:func:`ref_mesh_run` on 4 fake host devices, the cases dealt into
    ``parts`` subprocesses that run at once (XLA compiles each program
    on one core)."""
    from concurrent.futures import ThreadPoolExecutor

    from conftest import FakeDeviceRunner

    keys = sorted(cases)
    shares = [{k: cases[k] for k in keys[i::parts]} for i in range(parts)]

    def run(share):
        return FakeDeviceRunner()(_MESH_CHILD.replace("@CASES@", repr(share)),
                                  n=4, timeout=900)
    out = {}
    with ThreadPoolExecutor(parts) as pool:
        for part in pool.map(run, shares):
            out.update(part)
    return out


def port_mesh_count(arch: str, override, dims):
    """The port's count of the same step as rank 0 of a fake process mesh
    of ``dims``."""
    import repro_torch.configs as pc
    from repro_torch.parallel.distributed import fake_process_mesh

    with fake_process_mesh(dims, ("data", "model")) as mesh:
        return count_cell(mesh_config(pc, arch, override),
                          ShapeConfig(*SHAPES["train"]), mesh)
