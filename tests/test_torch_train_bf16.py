"""The port's training step on the dense decoders and qwen2-vl as shipped
(``dtype="bfloat16"``: f32 masters cast to bf16 each step) against the
reference's: loss and grad_norm within rtol 2e-2
(``torch_train_parity.check_bf16_step``).  The other configs are in
``test_torch_train_bf16_families.py``."""
import pytest

from torch_train_parity import DENSE, check_bf16_step, few_threads  # noqa: F401 (a fixture)


@pytest.mark.parametrize("name", DENSE)
def test_bf16_step_matches_reference(name):
    check_bf16_step(name)
