"""The port's per-group optimizer options against optax, as the JAX
package's ``build_optimizer`` composes them: ``physics_lr_mult`` and
``bg_lr_mult`` (``multi_transform`` branches ``chain(opt, scale)``, with
``bg_lr_mult=0`` freezing the background) and ``grad_clip``
(``clip_by_global_norm`` chained into the ``train`` branch only, or over
every parameter when there is no other branch). Four steps on the same
gradients, the LR anneal landing on the fourth.

Tolerance: rtol 1e-6 / atol 1e-7 on the parameters (a few f32 operations
per element; the global norm summed in another order).
"""
import numpy as np
import optax
import pytest
import torch

from paig_reproduction_tpu.train import optimizers as jax_opt
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.train import optimizers


def _tree(seed, scale=1.0):
    """A parameter tree with a physics scalar pair, a background net and
    an encoder layer, as flax names them."""
    rs = np.random.RandomState(seed)

    def arr(*shape):
        return np.asarray(rs.randn(*shape) * scale, np.float32)
    return {"log_k": arr(), "log_equil": arr(),
            "var_net_background": {"TorchDense_0": {"kernel": arr(10, 6),
                                                    "bias": arr(6)}},
            "encoder": {"TorchDense_0": {"kernel": arr(8, 5),
                                         "bias": arr(5)}}}


CASES = [
    dict(physics_lr_mult=3.0),
    dict(bg_lr_mult=0.0),
    dict(bg_lr_mult=0.25),
    dict(grad_clip=0.5),
    dict(physics_lr_mult=3.0, bg_lr_mult=0.0, grad_clip=0.5),
    dict(physics_lr_mult=3.0, grad_clip=1e6),
]


@pytest.mark.parametrize("name", ["rmsprop", "adam"])
@pytest.mark.parametrize("options", CASES,
                         ids=lambda o: ",".join(f"{k}={v}"
                                                for k, v in o.items()))
def test_group_options_match_optax(name, options):
    params = _tree(0)
    grads = [_tree(i + 1, scale=3.0) for i in range(4)]
    schedule = jax_opt.lr_schedule(6e-4, 2, 2, True)
    tx = jax_opt.build_optimizer(name, schedule, params, **options)
    state = tx.init(params)
    j_params = params
    for g in grads:
        updates, state = tx.update(g, state, j_params)
        j_params = optax.apply_updates(j_params, updates)

    t_params = {k: torch.nn.Parameter(v) for k, v in
                flax_to_state_dict(params).items()}
    opt = optimizers.build_optimizer(name, t_params.items(), 6e-4, **options)
    lr_at = optimizers.lr_schedule(6e-4, 2, 2, True)
    for step, g in enumerate(grads):
        optimizers.set_lr(opt, lr_at(step))
        for k, v in flax_to_state_dict(g).items():
            t_params[k].grad = v.clone()
        if opt.grad_clip > 0:
            optimizers.clip_train_group_(opt, opt.grad_clip)
        opt.step()
    ref = flax_to_state_dict(j_params)
    for k, p in t_params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    if options.get("bg_lr_mult") == 0.0:
        start = flax_to_state_dict(params)
        for k in t_params:
            if k.startswith("var_net_background"):
                assert torch.equal(t_params[k].detach(), start[k])


def test_labels_match_jax():
    """The groups the port builds are the JAX package's labels."""
    options = dict(physics_lr_mult=2.0, bg_lr_mult=0.5)
    opt = optimizers.build_optimizer(
        "rmsprop", ((k, torch.nn.Parameter(v)) for k, v in
                    flax_to_state_dict(_tree(0)).items()), 1e-3, **options)
    got = {g["label"]: len(g["params"]) for g in opt.param_groups}
    assert got == {"train": 2, "physics": 2, "background": 2}
    assert [g["scale"] for g in opt.param_groups] == [1.0, 2.0, 0.5]
    assert optimizers.param_label("encoder.dense.0.log_m") == "frozen"
