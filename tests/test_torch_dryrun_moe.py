"""The dry run's dot FLOPs of the MoE and MLA smoke families against the
reference's ``analyze_hlo`` on a one-device mesh, at their stated ratios
(``tests/torch_dryrun_parity.py::RATIO``): the reference's MoE dispatch
and combine are one-hot einsums, counted as dots, where the port gathers
and scatters."""
import pytest

import torch_dryrun_parity as parity
from torch_train_parity import few_threads  # noqa: F401 (a fixture)


@pytest.mark.parametrize("arch,step", parity.cases(
    ["granite-moe-3b-a800m-smoke", "deepseek-v2-236b-smoke"]))
def test_moe_dot_flops_at_their_stated_ratio(arch, step):
    parity.check(arch, step)
