"""RRDBNet (ESRGAN, Real-ESRGAN x4plus) as an inference ``nn.Module``.

basicsr's ``RRDBNet`` (``basicsr/archs/rrdbnet_arch.py``) at scale 4: the
layer equations and the launch schedule are ``ops/fused/rrdb.py``'s. The
image goes in at low resolution, RGB in 0..1, and comes out four times as
wide and tall, before any clamp.
"""

from __future__ import annotations

from torch import nn

from ..profiling import span


class RRDBNet(nn.Module):
    """Inference model holding one flat layer list in basicsr's
    ``state_dict`` order (conv_first, ``body.{b}.rdb{1,2,3}.conv{1..5}``,
    conv_body, conv_up1, conv_up2, conv_hr, conv_last; HWIO weights), every
    shape checked (``rrdb.layout``: ValueError). ``forward`` runs
    ``rrdb.forward`` in ``precision`` ("f32" or "bf16") inside a
    ``model.forward`` span. The tensors are buffers, shared with the list it
    was built from."""

    def __init__(self, params, precision: str = "bf16"):
        from ..ops.fused import rrdb

        super().__init__()
        self.channels, self.num_feat, self.num_grow_ch, self.num_block = rrdb.layout(params)
        self.num_layers = len(params)
        self.precision = precision
        for i, layer in enumerate(params):
            self.register_buffer(f"w{i + 1}", layer["w"])
            self.register_buffer(f"b{i + 1}", layer["b"])

    def layers(self):
        return [{"w": getattr(self, f"w{i + 1}"), "b": getattr(self, f"b{i + 1}")}
                for i in range(self.num_layers)]

    def forward(self, x):
        """(N, H, W, C) f32 in 0..1 → (N, 4H, 4W, C) f32."""
        from ..ops.fused import rrdb

        with span("model.forward"):
            return rrdb.forward(self.layers(), x, self.precision)
