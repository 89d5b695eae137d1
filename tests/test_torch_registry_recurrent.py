"""Port parity of the registry's recurrent smoke configs, xlstm-350m
(sLSTM + mLSTM) and jamba-1.5-large-398b (Mamba + attention, MoE): the
forward logits, the loss and every parameter's gradient (``jax.value_and_grad``
against autograd) on the same weights and batch, as
``tests/test_torch_registry.py`` holds the other eight (xlstm-350m at the
tolerance its conditioning allows, ``ILL_CONDITIONED`` there)."""

import pytest
import torch

from test_torch_registry import RECURRENT, check_forward_and_grads, reference_case

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


@pytest.mark.parametrize("arch", RECURRENT)
def test_forward_loss_and_grads_match_reference(arch):
    check_forward_and_grads(arch, reference_case(arch))
