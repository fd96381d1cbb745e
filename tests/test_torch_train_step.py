"""The smaller pieces of the dry-run slice against the JAX package, on the
CPU: ``optim.clip_by_global_norm``; ``launch.steps.make_train_step`` with no
rules, one AdamW step of reduced TinyLlama (fp32) at 1 and 2 microbatches
from the same weights and batch; and ``MoEBlock`` at ``moe_groups`` 4, its
output, aux and gradients against the JAX ``moe_block``.

Tolerances are the trainer tests' (``tests/test_torch_trainer.py``): the
loss rtol 1e-5; the gradient norm rtol 1e-5; after AdamW every element
within 2 x lr of the JAX step's and all but 1e-4 of them within 1e-6 (an
element whose gradient is ~0 on both sides can take a visibly different
Adam update from a last-ulp difference).  The clip is f32 arithmetic on
the same inputs: rtol 1e-6.  The MoE block is ``test_torch_moe.py``'s:
output 1e-5, aux rtol 1e-6, gradients 1e-4 x max |g|.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_arch as A
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.common import MoE as JaxMoE
from repro.models.moe import moe_block as jax_moe_block
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch.launch.steps import make_train_step
from repro_torch.models import from_jax_params
from repro_torch.models.common import MoE
from repro_torch.models.moe import MoEBlock
from repro_torch.optim import clip_by_global_norm, make_optimizer

LR = 1e-3


@pytest.mark.parametrize("max_norm", [0.05, 1e6], ids=["clipped", "unclipped"])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((7, 5)).astype(np.float32),
             "b": rng.standard_normal(13).astype(np.float32),
             "c": rng.standard_normal((3, 4)).astype(np.float32)}
    jout, jnorm = jax_clip({k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
    tgrads = {k: torch.from_numpy(v) for k, v in grads.items()}
    tgrads["d"] = torch.from_numpy(grads["c"]).to(torch.bfloat16)
    out, norm = clip_by_global_norm(tgrads, max_norm)
    jout_d, jnorm_d = jax_clip({**{k: jnp.asarray(v) for k, v in grads.items()},
                                "d": jnp.asarray(grads["c"]).astype(jnp.bfloat16)}, max_norm)
    assert float(jnorm_d) > float(jnorm)  # the bf16 leaf counts in the norm
    np.testing.assert_allclose(float(norm), float(jnorm_d), rtol=1e-6)
    for k in grads:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout_d[k]), rtol=1e-6, atol=1e-7)
    assert out["d"].dtype == torch.bfloat16
    np.testing.assert_allclose(out["d"].float().numpy(), np.asarray(jout_d["d"], np.float32),
                               rtol=1e-2)
    assert (float(jnorm) > max_norm) == (max_norm < 1)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference_after_one_adamw_step(n_micro):
    jcfg, tcfg = A.cfgs("tinyllama-1.1b")
    params = A.weights(jcfg)
    b = A.batch(tcfg, batch=4, seq=64)
    jopt = jax_make_optimizer("adamw")
    jparams = jax.tree.map(jnp.asarray, params)
    jstep = jax.jit(jax_make_train_step(jcfg, None, jopt, lr=LR, grad_clip=0.5,
                                        n_microbatches=n_micro))
    jnew, _, jm = jstep(jparams, jopt.init(jparams), {k: jnp.asarray(v) for k, v in b.items()})

    model = A.port_model(tcfg, params)
    opt = make_optimizer("adamw")
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(tcfg, None, opt, lr=LR, grad_clip=0.5, n_microbatches=n_micro)
    _, state, m = step(model, state, {k: torch.from_numpy(v) for k, v in b.items()})

    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=A.LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert float(jm["grad_norm"]) > 0.5  # the clip acted
    want = from_jax_params(jax.tree.map(np.asarray, jnew), tcfg)
    errs = np.concatenate([np.abs(p.detach().numpy() - want[n]).ravel()
                           for n, p in model.named_parameters()])
    assert errs.max() <= 2 * LR
    assert (errs > 1e-6).mean() <= 1e-4


def test_moe_block_at_four_groups_matches_reference():
    jcfg, tcfg = A.cfgs("mixtral-8x7b")
    jcfg = dataclasses.replace(jcfg, moe=JaxMoE(4, 2, 1.25), moe_groups=4)
    tcfg = dataclasses.replace(tcfg, moe=MoE(4, 2, 1.25), moe_groups=4)
    p = {k: v[0] for k, v in A.weights(jcfg)["stages"]["moe_0"]["moe"].items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((A.B, A.S, jcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    block = MoEBlock(tcfg, device="cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(block, k).copy_(torch.from_numpy(np.array(v)))
    (jout, jaux), vjp = jax.vjp(lambda jp, jx: jax_moe_block(jp, jx, jcfg),
                                jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(cot), jnp.asarray(1.0, jnp.float32)))
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = block(tx)
    (torch.sum(out * torch.from_numpy(cot)) + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    for name, want in list(jgp.items()) + [("x", jgx)]:
        got = (tx.grad if name == "x" else getattr(block, name).grad).numpy()
        want = np.asarray(want)
        assert float(np.abs(got - want).max()) <= A.GRAD_REL * float(np.abs(want).max()), name
    # four groups route differently from one: the groups are really there
    block.cfg = dataclasses.replace(tcfg, moe_groups=1)
    with torch.no_grad():
        one, _ = block(tx.detach())
    assert not torch.equal(one, out.detach())
