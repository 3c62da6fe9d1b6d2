"""The causal transformer gar (models/transformer.py): the model's
required operations. Its products run on cuBLAS and its attention on the
flash kernels (counts/flash.py), so it has no kernel function of its
own."""


def applies(d):
    return d["model"]["ar"]["kind"] == "transformer"


def forward(d):
    return None


def backward(d):
    return None


def model_flops(d):
    """Input projection; a layer's q, k, v and out projections and its MLP;
    causal attention's two products over half the scores."""
    ar = d["model"]["ar"]
    bt, a, h = d["B"] * d["T"], d["A"], ar["num_heads"]
    per_layer = (4 * 2.0 * bt * a * a + 2 * 2.0 * bt * a * a * ar["mlp_ratio"]
                 + 2 * 2.0 * (a // h) * (d["T"] * (d["T"] + 1) // 2)
                 * d["B"] * h)
    return 2.0 * bt * d["D"] * a + ar["num_layers"] * per_layer
