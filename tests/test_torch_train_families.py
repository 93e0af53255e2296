"""The port's training step on the recurrent and encoder-decoder
families (mamba2's SSD, recurrentgemma's RG-LRU with local attention,
whisper's encoder-decoder) against the reference's at f32; tolerances in
``torch_train_parity.check_f32_step``; beside its case lists that module
says why the parity cases are spread over several files."""
import pytest

from torch_train_parity import RECURRENT_ENCDEC, check_f32_step, few_threads  # noqa: F401 (a fixture)


@pytest.mark.parametrize("name", RECURRENT_ENCDEC)
def test_f32_loss_grads_and_step_match_reference(name):
    check_f32_step(name)
