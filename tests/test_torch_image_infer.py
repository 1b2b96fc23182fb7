"""The pruned programs of paddle_tpu_torch's image classifiers beyond
ResNet against the JAX package's on the CPU: each model of
``test_torch_image_models.py`` (LeNet, SmallNet, VGG-16, AlexNet,
GoogLeNet at small input sizes, from the JAX startup's weights) pruned to
its prediction, its 3x3 stride-1 convs routed onto the conv kernel (its
plain version on the CPU), the logits and the prediction within 1e-5 of
their max abs."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.fusion import is_igemm_conv, route_inference
from test_torch_image_models import (FWD_TOL, MODELS, _build, _feed,
                                     _jax_weights, _port_exe)

# the 3x3 stride-1 pad-1 convs a pruned program routes
ROUTED = {"lenet": 0, "smallnet": 1, "vgg16": 13, "alexnet": 3,
          "googlenet": 10}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread while these tests run: the suite's workers
    share the host's cores, and torch's thread pool on many small ops
    under that contention runs tens of times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_state():
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
    yield


@pytest.mark.parametrize("model", sorted(MODELS))
def test_pruned_inference_matches_jax(model):
    """The program pruned to the prediction (no loss, label or optimizer
    op; dropout scaled by 1 - p), its 3x3 stride-1 convs routed onto the
    conv kernel (its plain version on the CPU), on 3 images: the logits
    and the prediction within 1e-5 of their max abs against JAX's pruned
    program."""
    _, jpred, jlog = _build(jfluid, model, train=False)
    jprog = jfluid.default_main_program().prune([jpred])
    jexe, weights = _jax_weights()
    feed = {"img": _feed(model, seed=1, n=3)["img"]}
    want = [np.asarray(a) for a in jexe.run(jprog, feed=feed,
                                            fetch_list=[jlog, jpred])]
    _, tpred, tlog = _build(tfluid, model, train=False)
    prog = tfluid.default_main_program().prune([tpred])
    assert {o.type for o in prog.list_ops()}.isdisjoint(
        {"cross_entropy", "mean", "accuracy"})
    routed = route_inference(prog, [tlog, tpred.name])
    n_routed = sum(is_igemm_conv(o, prog) for o in prog.list_ops())
    assert n_routed == ROUTED[model]
    if n_routed:
        assert sum(o.fn.__name__ == "_igemm_fn" for o in routed) == n_routed
    else:
        assert routed is None
    got = _port_exe(weights, prog).run(prog, feed=feed,
                                       fetch_list=[tlog, tpred])
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= FWD_TOL * np.abs(b).max()
