"""The dry run's dot FLOPs of the smoke families other than the dense
decoders against the reference's ``analyze_hlo`` on a one-device mesh:
each family's port/reference ratio at its stated value
(``tests/torch_dryrun_parity.py::RATIO``, with the reason for each).
MoE and MLA are in ``test_torch_dryrun_moe.py`` (their reference
compiles are the slowest)."""
import pytest

import torch_dryrun_parity as parity
from torch_train_parity import few_threads  # noqa: F401 (a fixture)


@pytest.mark.parametrize("arch,step", parity.cases(
    ["qwen2-vl-2b-smoke", "mamba2-2.7b-smoke", "recurrentgemma-9b-smoke",
     "whisper-medium-smoke"]))
def test_family_dot_flops_at_their_stated_ratio(arch, step):
    parity.check(arch, step)
