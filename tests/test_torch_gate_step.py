"""One step of the integration gate's C4 config in the port against the JAX
package's: FIXED_PARAMS () trains the frozen BNs' affines
(``make_optimizer(train_bn_affines=True)``), from JAX's own initial weights
(``model.init`` on the gate's first batch) with JAX's sampling draws
injected (ROADMAP rule 7)."""

import jax
import numpy as np
import optax
import torch

from mx_rcnn_tpu.core.train import create_train_state, make_optimizer as j_make_optimizer
from mx_rcnn_tpu.core.train import make_train_step as j_make_train_step
from mx_rcnn_tpu.data.loader import TrainLoader as JTrainLoader
from mx_rcnn_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.tools import integration_gate as jgate
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.models import faster_rcnn as tfr
from mx_rcnn_tpu_torch.tools import integration_gate as tgate
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, torch_to_flax

torch.set_num_threads(2)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_gate_step_matches_jax_with_trained_bn_affines():
    """The gate's first C4 step from JAX's own init (``model.init`` on the
    gate's first batch) with JAX's draws: every loss and aux within 1e-4 relative, and every
    updated tensor, the BN scales and biases included, within 1e-3
    relative L2 (XLA's and torch's convs round apart; the deep BN biases
    start at 0, so their first update is all rounding's)."""
    jcfg, tcfg = jgate.gate_cfg("resnet50"), tgate.gate_cfg("resnet50")
    roidb = JSyntheticDataset(num_images=2, num_classes=4, image_size=(128, 128), max_boxes=2,
                              seed=0).gt_roidb()
    batch = next(iter(JTrainLoader(roidb, jcfg, 2, shuffle=True, seed=0)))
    jmodel = j_build_model(jcfg)
    params = jax.jit(lambda b: jmodel.init(
        {"params": jax.random.key(0), "sampling": jax.random.key(1)}, train=True, **b))(batch)
    params = params["params"]
    model = flax_to_torch(jax.tree.map(np.asarray, params), build_model(tcfg)).train()
    lr = 2e-3
    tx = j_make_optimizer(jcfg, optax.piecewise_constant_schedule(lr, {200: 0.1}))
    state, jaux = j_make_train_step(jmodel, tx, donate=False)(
        create_train_state(params, tx), batch, jax.random.key(123))

    # the uniforms the JAX step draws: fold_in(rng, step) → train_forward's
    # key, folded with each image's sample seed
    k = jmodel.apply({"params": params}, method=lambda m: m.make_rng("sampling"),
                     rngs={"sampling": jax.random.fold_in(jax.random.key(123), 0)})
    n_anchors, n_cand = 8 * 8 * 9, jcfg.TRAIN.RPN_POST_NMS_TOP_N + jcfg.dataset.MAX_GT_BOXES
    per = []
    for s in np.asarray(batch["sample_seeds"]):
        ka, kr = jax.random.split(jax.random.fold_in(k, int(s)), 2)
        per.append([jax.random.uniform(x, (n_anchors,)) for x in jax.random.split(ka)]
                   + [jax.random.uniform(x, (n_cand,)) for x in jax.random.split(kr, 3)])
    draws = {name: torch.from_numpy(np.stack([np.asarray(p[i]) for p in per]))
             for i, name in enumerate(tfr.DRAW_NAMES)}

    opt = ttrain.make_optimizer(tcfg, model, lambda c: lr, train_bn_affines=True)
    n_bn = sum(1 for n, _ in model.named_parameters() if n.endswith((".scale", ".bias"))
               and "bn" in n.rsplit(".", 2)[-2])
    assert n_bn == 2 * 53 and len(opt.params) == len(list(model.parameters()))
    tb = {k: (torch.from_numpy(np.asarray(v)) if k != "sample_seeds"
              else [int(x) for x in np.asarray(v)]) for k, v in batch.items()}
    _, taux = ttrain.train_step(ttrain.create_train_state(model, opt), tb, 123, draws=draws)
    for name in jaux:
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=1e-4, err_msg=name)
    got = dict(_leaves(torch_to_flax(model)))
    for path, want in _leaves(jax.tree.map(np.asarray, state.params)):
        err = np.linalg.norm(got[path] - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= 1e-3, ("/".join(path), err)
