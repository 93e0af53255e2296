"""Small-size runs of the port's examples on the CPU:
``examples/torch_quickstart.py`` (every metric on both backends, add and
delete, ``cache_info()``, ``explain()`` with the FLOP cross-check) and
``examples/torch_knn_search.py`` (a (2, 4) mesh of eight logical CPU
shards: sharded search with a batch axis, a sharded add, the pruned l2
search, the sharded kNN-LM datastore)."""
import importlib.util
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    path = os.path.join(REPO, "examples", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_on_the_cpu():
    out = _example("torch_quickstart.py").main(
        ["--device", "cpu", "--n", "8192", "--m", "32"])
    for metric in ("mips", "l2", "cosine"):
        assert out[metric, "torch"] == out[metric, "cuda"] >= 0.9
    assert out["after_add"] >= 0.9 and not out["leaked"]
    assert out["cache_info"]["entries"] == 0  # no graphs on the CPU
    assert abs(out["flops_ratio"] - 1.0) < 1e-9


def test_knn_search_on_a_cpu_mesh():
    out = _example("torch_knn_search.py").main(
        ["--device", "cpu", "--n", "8192"])
    assert out["recall", "mips"] >= 0.9 and out["recall", "l2"] >= 0.9
    assert out["after_add"] >= 0.9 and out["cluster"] >= 0.85
    assert out["finite"]
