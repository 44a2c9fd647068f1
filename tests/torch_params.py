"""The port's trained parameters against the JAX package's, for the tests
that train both packages side by side."""

import numpy as np


def assert_params_match_jax(params, jparams, rtol=1e-4, atol=1e-6):
    """The port's parameters against the JAX package's, leaf by leaf; a
    SAGE layer's one ``weights`` [2 d_in, d_out] by its halves, the top
    against JAX's ``w_self`` and the bottom against its ``w_neigh``."""
    for layer, jlayer in zip(params, jparams):
        if "w_self" in jlayer:
            w = layer["weights"].detach().numpy()
            d = w.shape[0] // 2
            pairs = [(w[:d], jlayer["w_self"]), (w[d:], jlayer["w_neigh"])]
        else:
            pairs = [(layer[k].detach().numpy(), jlayer[k]) for k in jlayer]
        for got, want in pairs:
            np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)
