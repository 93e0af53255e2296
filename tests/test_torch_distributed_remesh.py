"""Re-meshing a sharded train state in place, and checkpoints a slab at a
time (ROADMAP item 14b.3), on the CPU.

Every port check runs in one spawn of 4 gloo ranks
(``tests/torch_remesh_parity.py::port_ranks``), the reference's in one
subprocess on 4 fake devices, both in the module fixture:

* ``remesh_state`` around (4, 1), (2, 2) and (1, 4) (every ordered pair)
  for every family, granite-20b with ``fsdp_params`` (ZeRO-3): bit-equal
  to the state saved on the old mesh and restored at the new one, and to
  the whole state cut for the new mesh; nothing holds the old mesh;
* step 1 on (4, 1), the re-mesh onto (2, 2), step 2, against the
  reference's GSPMD steps around its own ``remesh_state`` (granite's
  ZeRO-3 case around its restore with ``shardings=``: its
  ``remesh_state`` puts the unsanitized spec, one kv head over "model");
* a (2, 2) checkpoint read by the reference, a reference checkpoint
  restored at (4, 1), (2, 2) and in one process, bit for bit;
* the entries stored uncompressed with zip64 extras, as ``np.savez``
  writes them; a compressed entry raises;
* each rank's ``HOST_PEAK`` over a save, a restore and an async save of
  a 6-layer config within one slab, the rank's share (async) and the
  stated slack, and below half of the whole state; the mark kept right
  by threads that hold and release at once; the async save equal to the
  synchronous one;
* a shard re-meshed onto a mesh that is not a process mesh raises,
  naming the checkpoint restart.
"""
import os
import zipfile

import numpy as np
import pytest
import torch

import torch_dist_parity as P
import torch_remesh_parity as R

from torch_train_parity import few_threads  # noqa: F401 (a fixture)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("remesh"))
    ref = R.reference(root)
    payload = dict(root=root, ref={k: dict(init=v["init"], checkpoint=v["checkpoint"])
                                   for k, v in ref.items()})
    return dict(root=root, ref=ref, port=P.spawn(4, R.port_ranks, payload, root))


@pytest.mark.parametrize("family", [R.family_name(a, f) for a, f in R.FAMILIES])
def test_remesh_equals_the_round_trip_and_the_cut(run, family):
    moves = run["port"]["families"][family]
    assert [m["pair"] for m in moves] == list(zip(R.CYCLE, R.CYCLE[1:]))
    for i, m in enumerate(moves):
        assert m["at"] == i and m["steps"] == (5, 5), m
        assert not m["vs_checkpoint"], (m["pair"], m["vs_checkpoint"])
        assert not m["vs_cut"], (m["pair"], m["vs_cut"])
        assert not m["other_mesh"], m["pair"]
        data, model = m["pair"][1]
        assert m["tp"] == (model > 1), m
        assert (m["data_split"] > 0) == (family.endswith("+fsdp") and data > 1), m


@pytest.mark.parametrize("key", list(R.STEP_CASES))
def test_step_after_the_remesh_matches_the_reference(run, key):
    got, want = run["port"]["steps"][key], run["ref"][key]
    for name in ("losses", "grad_norms"):
        assert np.all(np.isfinite(got[name])), (key, name, got[name])
        np.testing.assert_allclose(got[name], want[name], rtol=P.F32_RTOL,
                                   err_msg=f"{key} {name}")


@pytest.mark.parametrize("key", list(R.STEP_CASES))
def test_the_reference_reads_a_22_checkpoint(run, key):
    got = run["port"]["steps"][key]
    at, state = P.reference_checkpoint(got["checkpoint"], R.STEP_CASES[key][0]["arch"])
    assert at == 2
    assert state.keys() == got["state"].keys()
    for k, v in got["state"].items():
        assert np.array_equal(state[k], v), k


@pytest.mark.parametrize("where", ["(4, 1)", "(2, 2)", "one process"])
def test_a_reference_checkpoint_restores_in_the_port(run, where):
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models import model as M

    arch = R.STEP_CASES["dense"][0]["arch"]
    directory = run["ref"]["dense"]["checkpoint"]
    if where == "one process":
        like = M.init_train_state(torch.Generator().manual_seed(9), R._config(arch),
                                  device="cpu")
        state, at = restore_checkpoint(directory, like)
        got = dict(at=at, step=int(state.step), state=P.state_numpy(state))
    else:
        got = run["port"]["restored"][tuple(int(x) for x in where[1:-1].split(","))]
    assert got["at"] == 1 and got["step"] == 1
    want = P.saved_state(directory, 1, arch)
    assert want.keys() == got["state"].keys()
    for k, v in want.items():
        assert np.array_equal(got["state"][k], v), k


def _local_extra_ids(path, info):
    """The header ids of an entry's local extra field."""
    import struct

    with open(path, "rb") as f:
        f.seek(info.header_offset)
        head = struct.unpack(zipfile.structFileHeader, f.read(zipfile.sizeFileHeader))
        f.seek(head[10], 1)
        extra = f.read(head[11])
    ids = []
    while len(extra) >= 4:
        hid, size = struct.unpack("<HH", extra[:4])
        ids.append(hid)
        extra = extra[4 + size:]
    return ids


def test_entries_are_stored_with_zip64_as_numpy_writes_them(run, tmp_path):
    path = os.path.join(run["port"]["steps"]["dense"]["checkpoint"], "step_00000002",
                        "arrays.npz")
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    twin = str(tmp_path / "savez.npz")
    np.savez(twin, **arrays)
    layouts = []
    for p in (path, twin):
        with zipfile.ZipFile(p) as z:
            infos = z.infolist()
        assert all(i.compress_type == zipfile.ZIP_STORED for i in infos), p
        assert all(0x0001 in _local_extra_ids(p, i) for i in infos), p
        layouts.append([(i.filename, i.file_size) for i in infos])
    assert layouts[0] == layouts[1]
    assert ".params/['embed']/['embedding']" in arrays


def test_a_compressed_entry_raises(tmp_path):
    from repro_torch.checkpoint import restore_checkpoint

    step = tmp_path / "step_00000001"
    step.mkdir()
    np.savez_compressed(step / "arrays.npz", **{"['w']": np.ones(3, np.float32)})
    (step / "META.json").write_text('{"step": 1, "leaf_paths": ["[\'w\']"]}')
    with pytest.raises(ValueError, match="compressed"):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros(3)})


@pytest.mark.parametrize("op", ["save", "restore", "async"])
def test_host_peak_is_one_slab(run, op):
    """A rank holds at most one slab, its share (an async save's copy),
    and the slack: gloo's staging of one gather round on rank 0 (every
    rank's part of a round, at most 64 MiB a part) and one written chunk
    of an assembled slab (at most 64 MiB)."""
    peaks = run["port"]["peaks"]
    slab, chunk, whole = peaks["slab"], peaks["chunk"], peaks["whole_bytes"]
    for r in peaks["ranks"]:
        slack = peaks["world"] * min(r["part"], chunk) + min(slab, chunk)
        share = r["share"] if op == "async" else 0
        assert r["peaks"][op] <= slab + share + slack, (op, r, slab, slack)
        assert r["peaks"][op] < whole / 2, (op, r, whole)
        assert r["held"] == 0 and not r["restored"], r
    lead = next(r for r in peaks["ranks"] if r["rank"] == 0)
    assert lead["peaks"][op] >= slab  # rank 0 holds a whole slab on its host


def test_host_peak_counts_under_concurrent_threads():
    """``HOST_PEAK`` is updated from a save's caller and an async
    writer's thread at once: 16 threads holding and releasing with a
    short switch interval leave nothing held and a peak no higher than
    all of them at once."""
    import sys
    import threading

    from repro_torch.checkpoint import checkpoint as ck

    def churn(nbytes):
        for _ in range(2000):
            with ck._holding(nbytes):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ck.reset_host_peak()
        threads = [threading.Thread(target=churn, args=(i + 1,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert ck.HOST_PEAK["held"] == 0
    assert 16 <= ck.reset_host_peak() <= sum(range(1, 17))


def test_the_async_save_equals_the_sync_save(run):
    peaks = run["port"]["peaks"]
    paths = [os.path.join(peaks[k], "step_00000001") for k in ("sync_dir", "async_dir")]
    metas = [open(os.path.join(p, "META.json")).read() for p in paths]
    assert metas[0] == metas[1]
    with np.load(os.path.join(paths[0], "arrays.npz")) as a, \
            np.load(os.path.join(paths[1], "arrays.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_a_shard_remeshed_off_its_process_group_raises(run):
    kind, msg = run["port"]["refusal"]
    assert kind == "ValueError", (kind, msg)
    assert "ProcessMesh" in msg and "checkpoint" in msg and "torchrun" in msg, msg
