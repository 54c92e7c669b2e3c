"""Helpers of the port's parity tests against the JAX package: the port's
weights as a flax param tree, NCHW <-> NHWC, and the relative check."""

import numpy as np
import torch


def to_flax(module: torch.nn.Module) -> dict:
    """The port's weights as a flax param tree in the JAX package's layout:
    Dense ``(in, out)``, Conv ``(kh, kw, in, out)``, norm ``scale``, Embed
    ``embedding``; a parameter of any other name (a raw table) as it is."""
    tree: dict = {}
    for name, mod in module.named_modules():
        params = dict(mod.named_parameters(recurse=False))
        if not params:
            continue
        node = tree
        for part in filter(None, name.split(".")):
            node = node.setdefault(part, {})
        for pname, p in params.items():
            w = p.detach().float().numpy()
            if pname == "bias":
                node["bias"] = w
            elif pname != "weight":
                node[pname] = w
            elif isinstance(mod, torch.nn.Embedding):
                node["embedding"] = w
            elif w.ndim == 1:
                node["scale"] = w
            else:
                node["kernel"] = w.T if w.ndim == 2 else w.transpose(2, 3, 1, 0)
    return tree


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def close(got, want, rel: float):
    """max |got - want| <= rel * max |want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))
