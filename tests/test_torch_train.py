"""The port's training step against the reference's, on the CPU: the
dense decoders and qwen2-vl's embeddings input with M-RoPE at f32
(``torch_train_parity.check_f32_step``: loss rtol 1e-5, gradients rtol
1e-4 atol 1e-6, one step's parameters rtol 1e-5 atol 1e-6).  The step's
options, the serving forwards' no-grad and ``input_specs`` are in
``test_torch_train_options.py``; the other configs' cases are in the
files ``torch_train_parity`` names beside its case lists.
"""
import pytest

from torch_train_parity import (  # noqa: F401 (few_threads: a fixture)
    DENSE,
    MLA,
    MOE,
    RECURRENT_ENCDEC,
    SMOKE,
    check_f32_step,
    few_threads,
)


@pytest.mark.parametrize("name", DENSE)
def test_f32_loss_grads_and_step_match_reference(name):
    check_f32_step(name)


def test_parity_cases_cover_every_smoke_config():
    """The f32 and bf16 parity files together hold each smoke config
    once."""
    cases = DENSE + [MOE, MLA] + RECURRENT_ENCDEC
    assert sorted(cases) == SMOKE and len(SMOKE) == 10
