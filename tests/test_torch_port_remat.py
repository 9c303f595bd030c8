"""`remat` on the port's plain UNet (models/unet.py): the blocks recomputed
in the backward through torch.utils.checkpoint. The step with remat equals
the step without it, bit for bit on the CPU (loss, gradients, BN buffers,
the dropout generator's state after the step), with dropout on and off; and
it matches the JAX package's remat step (`UNet(remat=True)`, the same
blocks under `nn.remat`) at the step bounds."""

import copy
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_torch_tpu.models.unet import UNet as JaxUNet
from unet_torch_tpu.train.optim import make_optimizer as jax_make_optimizer
from unet_torch_tpu.train.state import TrainState
from unet_torch_tpu.train.steps import make_single_steps as jax_steps
from unet_torch_tpu_torch.models.unet import UNet, build_model
from unet_torch_tpu_torch.train.optim import make_optimizer
from unet_torch_tpu_torch.train.steps import make_single_steps

from test_torch_port_train_step import TOL, WD, _setup


def _step(model, x, y, seed):
    opt = make_optimizer("SGD", model.parameters(), 0.01, WD)
    step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", 3)
    gen = torch.Generator().manual_seed(seed)
    loss = step(model, opt, x, y, 0.01, gen)
    return (loss, {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()},
            gen.get_state())


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_remat_step_equals_the_plain_step_bitwise(dropout):
    """The recompute replays the forward's dropout masks and leaves the BN
    running statistics as the forward updated them, once."""
    torch.manual_seed(0)
    plain = UNet(3, 3, base=8, dropout=dropout > 0, dropout_p=dropout)
    remat = copy.deepcopy(plain)
    remat.remat = True
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 3, (2, 32, 32)).astype(np.float32))
    a, b = _step(plain, x, y, 7), _step(remat, x, y, 7)
    assert torch.equal(a[0], b[0])
    for got, want in ((b[1], a[1]), (b[2], a[2])):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert torch.equal(a[3], b[3])
    # the BN statistics moved once: num_batches_tracked is 1
    assert all(v.item() == 1 for k, v in b[2].items()
               if k.endswith("num_batches_tracked"))
    for p, q in zip(plain.parameters(), remat.parameters()):
        assert torch.equal(p, q)


def test_remat_step_matches_the_jax_remat_step():
    """SGD, dice_bce_mc, UNet base 8: JAX's UNet(remat=True) step and the
    port's, from the same bridged weights (remat keeps the parameter
    tree)."""
    _, port, x, y, params, batch_stats, bridge, _ = _setup("unet")
    port.remat = True
    model = JaxUNet(3, 3, base=8, remat=True)
    tx = jax_make_optimizer("SGD", 0.01, WD)
    train_step, _ = jax_steps(model, tx, "dice_bce_mc", "dice_bce_mc", 3)
    state = TrainState.create(params, batch_stats, tx)
    state, jloss = train_step(state, jnp.asarray(x), jnp.asarray(y), 0.01,
                              jax.random.key(0))
    after = bridge(jax.tree_util.tree_map(np.asarray, state.params),
                   jax.tree_util.tree_map(np.asarray, state.batch_stats))
    loss = _step(port, torch.from_numpy(x), torch.from_numpy(y), 0)[0]
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(),
                                   err_msg=name, **TOL)


def test_build_model_takes_remat_for_the_plain_unet_only():
    """As the JAX CLI passes it: `single` and `regression` recompute; the
    other types accept it with a warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model = build_model("regression", n_channels=3, n_classes=1, base=4,
                            remat=True)
    assert model.remat
    assert not build_model("single", n_channels=3, n_classes=1,
                           base=4).remat
    with pytest.warns(UserWarning, match="remat"):
        build_model("attention", n_channels=3, n_classes=1, base=4,
                    remat=True)


def test_remat_changes_nothing_in_eval_or_without_autograd():
    torch.manual_seed(0)
    model = UNet(3, 2, base=4, remat=True)
    x = torch.randn(1, 16, 16, 3)
    model.eval()
    with torch.no_grad():
        a = model(x)
    model.remat = False
    with torch.no_grad():
        b = model(x)
    assert torch.equal(a, b)
