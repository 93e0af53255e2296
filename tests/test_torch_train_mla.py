"""The port's training step on deepseek-v2 (MLA attention, MoE with
shared experts) against the reference's at f32, with the exact router
and the approx router; tolerances in
``torch_train_parity.check_f32_step``; beside its case lists that module
says why the parity cases are spread over several files."""
import pytest

from torch_train_parity import MLA, ROUTERS, check_f32_step, few_threads  # noqa: F401 (a fixture)


@pytest.mark.parametrize("routing", ROUTERS)
def test_f32_loss_grads_and_step_match_reference(routing):
    check_f32_step(MLA, router_topk_impl=routing)
