"""The benchmark's own spans around the calls into the program's layers,
recorded only in a traced run (``--trace 1``):

* ``bench.api:<S>x<H>x<W>`` around ``api.upscale_batch`` and
  ``api.upscale_image`` (S images of H x W, after any pre-scale): the API
  layer, whose shape is the unpadded image the model's work is counted on;
* ``bench.net:<input shape>`` around the forward call of every module of
  the model's class (``models/srcnn.py: SRCNN``), by a global module
  forward hook: everything launched inside it is the conv stack's.

Both are ``torch.profiler`` annotations on the calling thread.
"""

from __future__ import annotations

import functools
import threading

import torch


class Spans:
    def __init__(self, api_module, model_cls):
        self.api, self.model_cls = api_module, model_cls
        self.local = threading.local()
        self.saved = {}
        self.handles = []

    def _stack(self):
        if not hasattr(self.local, "stack"):
            self.local.stack = []
        return self.local.stack

    def _wrap(self, name):
        fn = getattr(self.api, name)
        self.saved[name] = fn

        @functools.wraps(fn)
        def wrapped(cfg, params, images, *args, **kwargs):
            shape = images.shape if images.ndim == 4 else (1, *images.shape)
            with torch.profiler.record_function(f"bench.api:{shape[0]}x{shape[1]}x{shape[2]}"):
                return fn(cfg, params, images, *args, **kwargs)
        setattr(self.api, name, wrapped)

    def _pre(self, module, args):
        if isinstance(module, self.model_cls):
            rec = torch.profiler.record_function(
                "bench.net:" + "x".join(str(d) for d in args[0].shape))
            rec.__enter__()
            self._stack().append(rec)

    def _post(self, module, args, out):
        if isinstance(module, self.model_cls):
            self._stack().pop().__exit__(None, None, None)

    def install(self) -> None:
        for name in ("upscale_batch", "upscale_image"):
            self._wrap(name)
        self.handles = [torch.nn.modules.module.register_module_forward_pre_hook(self._pre),
                        torch.nn.modules.module.register_module_forward_hook(self._post)]

    def remove(self) -> None:
        for name, fn in self.saved.items():
            setattr(self.api, name, fn)
        for h in self.handles:
            h.remove()
        self.saved, self.handles = {}, []
