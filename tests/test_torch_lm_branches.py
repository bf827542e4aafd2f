"""The LM branches the parity tests at (2, 16) never reach, against the JAX
package's, on the CPU, at the 1e-5 target of ``tests/torch_lm_common.py``
(max |port - ref| <= 1e-5 * max |ref|):

* the sliding window (``window=32``) of the reduced ``mixtral-8x7b`` and
  ``recurrentgemma-2b`` configs: forward at seq 96 and 100 (q_chunk 16 and
  20, the second not a divisor of the sequence);
* the MoE capacity branch, which engages above T = 512 tokens
  (``models/layers.py``): forward at T = 600 and 1024 on the reduced
  ``olmoe-1b-7b`` and ``mixtral-8x7b``, logits and aux;
* a 60-token prefill into the rolling buffer of the windowed configs and
  19 decode steps past it, each step's logits held.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_common as C
from repro.models import build as jbuild
from repro_torch.models import build

WINDOWED = ["mixtral-8x7b", "recurrentgemma-2b"]


def _pair(name):
    jcfg, cfg = C.configs(name)
    return jbuild(jcfg), build(cfg), C.reference_params(name), \
        C.port_model(name)


@pytest.mark.parametrize("seq,q_chunk", [(96, 16), (100, 20)])
@pytest.mark.parametrize("name", WINDOWED)
def test_sliding_window_forward_matches_reference(name, seq, q_chunk):
    japi, api, jparams, model = _pair(name)
    tokens, _ = C.inputs(name, batch=2, seq=seq, seed=7)
    want, jaux = japi.forward(jparams, jnp.asarray(tokens), None,
                              q_chunk=q_chunk)
    with torch.no_grad():
        got, aux = api.forward(model, torch.as_tensor(tokens), None,
                               q_chunk=q_chunk)
    assert C.rel_err(got, want) <= C.REL
    assert abs(float(aux) - float(jaux)) <= C.REL * max(abs(float(jaux)), 1.0)


@pytest.mark.parametrize("batch,seq", [(2, 300), (2, 512)])
@pytest.mark.parametrize("name", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_capacity_branch_matches_reference(name, batch, seq):
    """T = batch * seq = 600 and 1024 tokens: above 512 the expert capacity
    is bounded and overflowing tokens drop."""
    japi, api, jparams, model = _pair(name)
    tokens, _ = C.inputs(name, batch=batch, seq=seq, seed=11)
    want, jaux = japi.forward(jparams, jnp.asarray(tokens), None, q_chunk=64)
    with torch.no_grad():
        got, aux = api.forward(model, torch.as_tensor(tokens), None,
                               q_chunk=64)
    assert C.rel_err(got, want) <= C.REL
    assert abs(float(aux) - float(jaux)) <= C.REL * abs(float(jaux))


@pytest.mark.parametrize("name", WINDOWED)
def test_decode_past_the_rolling_buffer_matches_reference(name):
    """Prefill 60 tokens (the buffer holds the window's 32), then decode 19
    more, each against the reference's step."""
    japi, api, jparams, model = _pair(name)
    prompt, steps = 60, 19
    tokens, _ = C.inputs(name, batch=2, seq=prompt + steps, seed=13)
    jlast, jcache = japi.prefill(jparams, jnp.asarray(tokens[:, :prompt]),
                                 None, q_chunk=8, cache_len=prompt,
                                 dtype=jnp.float32)
    with torch.no_grad():
        last, cache = api.prefill(model, torch.as_tensor(tokens[:, :prompt]),
                                  None, q_chunk=8, cache_len=prompt,
                                  dtype=torch.float32)
    assert C.rel_err(last, jlast) <= C.REL
    for i in range(steps):
        pos = prompt + i
        jstep, jcache = japi.decode_step(jparams, jcache,
                                         jnp.asarray(tokens[:, pos]),
                                         jnp.asarray(pos, jnp.int32))
        step, cache = api.decode_step(model, cache,
                                      torch.as_tensor(tokens[:, pos]), pos)
        assert C.rel_err(step, np.asarray(jstep)) <= C.REL, i
