"""The ``:predict`` path of the port against the reference's
``ClassifierPredictor``.

The reference predictor inits a non-generative registry model from its
seed; its ``save_streamable`` checkpoint restores into the port's
``ClassifierPredictor``, whose logits on the same numpy inputs must lie
within 1e-5 (float32) of the reference's, with the same argmax
predictions, directly and over HTTP.  ResNet's BatchNorm reads running
averages that the reference's ``apply({"params": p}, x)`` does not carry:
both packages refuse to predict with it.
"""

import io
import json

import numpy as np
import pytest
import torch

from kubeflow_tpu.serving import model_pool as jmp
from kubeflow_tpu.serving.predictor import ClassifierPredictor as JaxCls
from kubeflow_tpu_torch.serving import predictor as tpred

CONFIGS = {
    "mnist_mlp": ({}, lambda rng: rng.standard_normal(
        (3, 28, 28, 1)).astype(np.float32)),
    "bert": ({"size": "tiny", "dtype": "float32"},
             lambda rng: rng.integers(0, 1024, (2, 12))),
    "cifar_convnet": ({}, lambda rng: rng.standard_normal(
        (2, 32, 32, 3)).astype(np.float32)),
}


def wsgi(app, path, body=None):
    raw = json.dumps(body).encode() if body is not None else b""
    env = {"REQUEST_METHOD": "POST" if body is not None else "GET",
           "PATH_INFO": path, "CONTENT_LENGTH": str(len(raw)),
           "wsgi.input": io.BytesIO(raw)}
    got = {}
    out = b"".join(app(env, lambda s, h: got.update(status=s)))
    return int(got["status"].split()[0]), json.loads(out)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_predict_matches_reference(name, tmp_path):
    config, make = CONFIGS[name]
    ref = JaxCls(name, model_config=config, seed=3)
    jmp.save_streamable(ref.params, str(tmp_path))
    port = tpred.ClassifierPredictor(name, model_config=config,
                                     checkpoint_dir=str(tmp_path),
                                     device="cpu")
    x = make(np.random.default_rng(0))
    want = ref.predict(x.tolist())
    got = port.predict(x.tolist())
    np.testing.assert_allclose(np.asarray(got["logits"]),
                               np.asarray(want["logits"]),
                               rtol=1e-5, atol=1e-5)
    assert got["predictions"] == want["predictions"]
    assert port.last_restore["tensors"] == len(
        dict(port.module.named_parameters()))
    status, body = wsgi(tpred.PredictorApp({name: port}),
                        f"/v1/models/{name}:predict",
                        {"instances": x.tolist()})
    assert status == 200 and body["predictions"] == want["predictions"]
    assert wsgi(tpred.PredictorApp({name: port}),
                f"/v1/models/{name}:predict", {"ids": [[1]]})[0] == 422


def test_seeded_init_without_checkpoint_is_deterministic():
    a = tpred.ClassifierPredictor("mnist_mlp", seed=5, device="cpu")
    b = tpred.ClassifierPredictor("mnist_mlp", seed=5, device="cpu")
    x = torch.randn(2, 28, 28, 1, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.forward(x), b.forward(x))
    with pytest.raises(ValueError, match="generative"):
        tpred.ClassifierPredictor("llama", device="cpu")


def test_resnet_predict_is_refused_as_in_the_reference():
    config = {"stage_sizes": [1, 1, 1, 1], "width": 8, "num_classes": 10}
    image = np.zeros((1, 224, 224, 3), np.float32).tolist()
    ref = JaxCls("resnet50", model_config=config)
    with pytest.raises(Exception, match="batch_stats"):
        ref.predict(image)
    port = tpred.ClassifierPredictor("resnet50", model_config=config,
                                     device="cpu")
    with pytest.raises(RuntimeError, match="batch_stats"):
        port.predict(image)
    # the reference's app has no handler for flax's error: a 500
    status, body = wsgi(tpred.PredictorApp({"resnet50": port}),
                        "/v1/models/resnet50:predict", {"instances": image})
    assert status == 500 and "batch_stats" in body["error"]


def test_main_builds_classifiers_outside_the_budget(monkeypatch):
    seen = {}

    class Stop(Exception):
        pass

    def serve(app, port):
        seen["app"] = app
        raise Stop

    import kubeflow_tpu_torch.serving.httpserve as hs
    from kubeflow_tpu_torch.serving import model_pool as tmp_

    monkeypatch.setattr(hs, "serve", serve)
    try:
        with pytest.raises(Stop):
            tpred.main(["--model", "mnist_mlp", "--weight-budget-mb", "1",
                        "--device", "cpu"])
        app = seen["app"]
        assert isinstance(app.predictors["mnist_mlp"],
                          tpred.ClassifierPredictor)
        assert not app.model_pool.has("mnist_mlp")
        status, meta = wsgi(app, "/v1/models/mnist_mlp")
        assert status == 200 and "residency" not in meta
    finally:
        tmp_.set_model_pool(None)
