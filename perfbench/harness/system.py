"""What every configuration's ``System`` shares: the port's modules built on
the meta device (a subclass's ``port_modules``), their state-dict shapes and
dtypes, the weights drawn on the card from the seed in those dtypes, the
modules loaded with them, and the reference's meta weights for FLOP counts."""

from __future__ import annotations

import torch

from perfbench.harness import weights as W


class PortSystem:
    COMPONENTS: tuple = ()

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.device = torch.device(device)

    def port_modules(self, cast: bool = True, **kw) -> dict:
        """component → the port's module on the meta device, in the dtypes
        the port serves it in (its ``cast_module_`` policy), or float32."""
        raise NotImplementedError

    def shapes(self) -> dict:
        return {f"{name}.{k}": v for name, m in self.port_modules().items()
                for k, v in W.shapes_of(m).items()}

    def draw(self, seed: int) -> dict:
        """component → state dict, drawn on the card from the seed."""
        return W.split(W.draw(self.shapes(), seed, self.device), self.COMPONENTS)

    def load(self, weights: dict, cast: bool = True, **kw) -> dict:
        """The port's modules on the device, holding ``weights``, in eval
        mode and without gradients."""
        mods = self.port_modules(cast=cast, **kw)
        for name, m in mods.items():
            m.to_empty(device=self.device)
            m.load_state_dict(weights[name], strict=True)
            m.eval().requires_grad_(False)
        return mods

    def meta_weights(self) -> dict:
        return W.meta(self.shapes(), self.COMPONENTS)


def cast(mods: dict) -> dict:
    from animate_anything_tpu_torch.core.dtypes import cast_module_

    for m in mods.values():
        cast_module_(m)
    return mods
