"""``ServeEngine(device="cpu")`` against the reference engine on the moe
(kimi-k2 and arctic), hybrid (jamba) and ssm (rwkv6) smoke configs:
``tests/test_serve.py``'s fixture (5 requests, 2 slots, 6 new tokens,
bf16) gives the same greedy tokens, the reference engine's prefill and
decode compiled with XLA's excess precision off (both packages round to
bf16 after each operation; see ``test_torch_families.py``)."""

import jax
import numpy as np
import pytest

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import smoke_config as jsmoke_config
from repro.models import model as jmodel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.models import model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request, ServeConfig, ServeEngine
from test_torch_families import MAX_SEQ, _reference


@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "arctic_480b",
                                  "jamba_v0_1_52b", "rwkv6_1_6b"])
def test_engine_greedy_tokens_equal_reference_engine(arch):
    """tests/test_serve.py's fixture (5 requests, 2 slots, 6 new tokens,
    bf16) on both engines: the same tokens."""
    jcfg = jsmoke_config(jget_arch(arch))
    cfg = smoke_config(get_arch(arch))
    jm = jmodel.build_model(jcfg, max_seq_len=MAX_SEQ)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")

    def reqs(cls):
        rng = np.random.default_rng(0)
        return [cls(rid=i, prompt=rng.integers(0, 200, 5 + i,
                                               dtype=np.int32),
                    max_new_tokens=6) for i in range(5)]

    jreqs = reqs(JRequest)
    jeng = JServeEngine(jm, jp, JServeConfig(max_len=MAX_SEQ, n_slots=2))
    jeng._prefill = _reference(
        lambda p, b: jm.prefill_fn(p, b, MAX_SEQ), "bf16")
    jeng._decode = _reference(jm.decode_fn, "bf16")
    jeng.generate(jreqs)
    treqs = reqs(Request)
    eng = ServeEngine(model.build_model(cfg, max_seq_len=MAX_SEQ), tp,
                      ServeConfig(max_len=MAX_SEQ, n_slots=2), device="cpu")
    eng.generate(treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [w.batch for w in eng.waves] == [2, 2, 1]
