"""The benchmark's own spans around the calls into the program's layers,
recorded only in a traced run (``--trace 1``):

* ``bench.api:<S>x<H>x<W>`` around ``api.upscale_batch`` and
  ``api.upscale_image`` (S images of H x W, after any pre-scale): the API
  layer, whose shape is the input the model's work is counted on;
* ``bench.net:<input shape>`` around the outermost forward call of any
  module whose class is defined in the port's model package
  (``type(m).__module__`` under ``cnn_sr_tpu_torch.models``), by a global
  module forward hook: everything launched inside it is the model's.
  Forward calls of the port's modules nested inside it open none, so a
  model built of child modules is one span a call, as ``SRCNN`` is.

Both are ``torch.profiler`` annotations on the calling thread.
"""

from __future__ import annotations

import functools
import threading

import torch

MODELS = "cnn_sr_tpu_torch.models"


def is_port_model(module) -> bool:
    name = type(module).__module__
    return name == MODELS or name.startswith(MODELS + ".")


class Spans:
    def __init__(self, api_module):
        self.api = api_module
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
        if is_port_model(module):
            stack = self._stack()
            rec = None
            if not stack:  # the outermost call opens the span
                rec = torch.profiler.record_function(
                    "bench.net:" + "x".join(str(d) for d in args[0].shape))
                rec.__enter__()
            stack.append(rec)

    def _post(self, module, args, out):
        if is_port_model(module):
            rec = self._stack().pop()
            if rec is not None:
                rec.__exit__(None, None, None)

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
