"""The port's decoder-only transformer families (dense, MoE, VLM:
``repro_torch.models.transformer``) against the JAX package's, on the CPU:
every dense, MoE and VLM config of ``tests/test_models_smoke.py`` plus
``demo``, each checked four ways with the reference's parameters carried
across (forward logits and aux, prefill's last logits, one decode step, the
port's decode against its own forward) and through one train step.  The
tolerances are stated in ``tests/torch_lm_common.py``."""
import pytest

import torch_lm_common as C

NAMES = C.family_names("dense", "moe", "vlm")


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name):
    C.check_forward(name)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_reference(name):
    C.check_prefill(name)


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference(name):
    C.check_decode(name)


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_own_forward(name):
    C.check_decode_matches_forward(name)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_reference(name):
    C.check_train_step(name)
