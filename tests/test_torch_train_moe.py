"""The port's training step on granite-moe (MoE) against the reference's
at f32, with the exact router and the approx router (``approx_max_k``);
tolerances in ``torch_train_parity.check_f32_step``; beside its case
lists that module says why the parity cases are spread over several
files.  The dispatch's backward gathers each token's slot gradients and
the combine's scatters to unique rows, so no atomic add runs
(``models/moe.py``)."""
import pytest

from torch_train_parity import MOE, ROUTERS, check_f32_step, few_threads  # noqa: F401 (a fixture)


@pytest.mark.parametrize("routing", ROUTERS)
def test_f32_loss_grads_and_step_match_reference(routing):
    check_f32_step(MOE, router_topk_impl=routing)
