"""Seeded weights, one module an init, named by a configuration's ``init``.

A module here defines ``make(layers, seed, **init_args)``: ``layers`` is
the configuration's ``[(f, k, n), ...]``, ``seed`` its ``weights_seed``,
``init_args`` its optional ``init_args``. It returns ``[(w (f, f, k, n)
f32, b (n,) f32), ...]`` in the order of ``layers``, drawn on the host
with numpy alone from ``np.random.default_rng(seed)``. ``weights.load``
checks the shapes and the digest that the configuration pins.
"""
