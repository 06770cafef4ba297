"""Prompt-to-prompt attention control and capture — the port of
``animate_anything_tpu/utils/ptp.py``.

An ``AttentionControl`` observes, and may rewrite, the attention
probabilities of every non-causal ``ops/attention.attention`` call in the
dynamic scope of ``attention_control(controller)``: the UNet's spatial
self- and cross-attention, tagged with their module path (set by
``tag_attention_paths`` when a UNet is built) and whether they attend to a
context; also the VAE's and CLIP vision's, untagged, as in JAX. While one is
active those calls materialise fp32 (b·heads, sq, sk) probabilities
(``ops/attention._controlled_attention``), so keep the shapes small: at
512 px and 16 frames one top-level site holds 34 × 5 × 4096² × 4 B ≈ 11.4
GB. ``AttentionStore`` averages the maps across steps;
``aggregate_attention`` folds them into one heatmap; the word / alpha
schedules of edits are numpy, as JAX's.
"""

from __future__ import annotations

import abc
import contextlib
import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from animate_anything_tpu_torch.utils.seq_align import get_word_inds  # re-export  # noqa: F401

_LOCAL = threading.local()  # .stack: the controllers this thread opened, innermost last


def active_controller() -> Optional["AttentionControl"]:
    """The innermost controller the calling thread opened, or None."""
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def attention_control(controller: "AttentionControl"):
    """Engage a controller for every attention() call in the dynamic scope,
    on the calling thread only (a server's worker thread keeps its own)."""
    stack = _LOCAL.__dict__.setdefault("stack", [])
    stack.append(controller)
    try:
        yield controller
    finally:
        stack.pop()


def place_in_unet(path: Tuple[str, ...]) -> str:
    """A module path → the reference's down / mid / up tagging."""
    for part in path:
        if part.startswith("down_blocks"):
            return "down"
        if part.startswith("mid_block"):
            return "mid"
        if part.startswith("up_blocks"):
            return "up"
    return "other"


def tag_attention_paths(root: nn.Module, rename: Optional[Dict[str, str]] = None) -> None:
    """Give each ``CrossAttention`` under ``root`` its module path (the
    dotted name split at the dots) for the controller's tag; ``rename`` maps
    a top-level name to the one JAX's module tree has there."""
    from animate_anything_tpu_torch.models.attention import CrossAttention

    for name, module in root.named_modules():
        if isinstance(module, CrossAttention):
            parts = name.split(".")
            if rename and parts[0] in rename:
                parts[0] = rename[parts[0]]
            module.path = tuple(parts)


class AttentionControl(abc.ABC):
    """Observes / edits attention probabilities."""

    def __init__(self):
        self.cur_step = 0
        self.num_att_layers = -1
        self.cur_att_layer = 0

    def step_callback(self, x_t):
        return x_t

    def between_steps(self):
        pass

    @abc.abstractmethod
    def forward(self, attn: torch.Tensor, is_cross: bool, place: str) -> torch.Tensor:
        ...

    def __call__(self, attn, is_cross: bool, place: str):
        out = self.forward(attn, is_cross, place)
        self.cur_att_layer += 1
        if self.num_att_layers > 0 and self.cur_att_layer >= self.num_att_layers:
            self.cur_att_layer = 0
            self.cur_step += 1
            self.between_steps()
        return out

    def reset(self):
        self.cur_step = 0
        self.cur_att_layer = 0


class EmptyControl(AttentionControl):
    def forward(self, attn, is_cross, place):
        return attn


class AttentionStore(AttentionControl):
    """Accumulates per-site attention maps, averaged across steps. Maps of
    more than ``max_size`` query positions are skipped (the 32² cap of
    upstream prompt-to-prompt). The maps stay on the probabilities' device."""

    def __init__(self, max_size: int = 32 ** 2):
        super().__init__()
        self.max_size = max_size
        self.step_store: Dict[str, list] = self.get_empty_store()
        self.attention_store: Dict[str, list] = {}

    @staticmethod
    def get_empty_store() -> Dict[str, list]:
        return {f"{p}_{c}": [] for p in ("down", "mid", "up", "other")
                for c in ("cross", "self")}

    def forward(self, attn, is_cross, place):
        key = f"{place}_{'cross' if is_cross else 'self'}"
        if attn.shape[-2] <= self.max_size:
            self.step_store[key].append(attn.detach().clone())
        return attn

    def between_steps(self):
        if not self.attention_store:
            self.attention_store = {k: list(v) for k, v in self.step_store.items()}
        else:
            for k in self.attention_store:
                for i in range(len(self.attention_store[k])):
                    self.attention_store[k][i] = (
                        self.attention_store[k][i] + self.step_store[k][i])
        self.step_store = self.get_empty_store()

    def get_average_attention(self) -> Dict[str, list]:
        steps = max(1, self.cur_step)
        return {k: [m / steps for m in v] for k, v in self.attention_store.items()}

    def reset(self):
        super().reset()
        self.step_store = self.get_empty_store()
        self.attention_store = {}


def aggregate_attention(store: AttentionStore, res: int, places: List[str],
                        is_cross: bool, batch_index: int = 0) -> torch.Tensor:
    """Average all (res², tokens) maps at the given resolution into one
    (res, res, tokens) heatmap."""
    maps = []
    num_pixels = res ** 2
    for place in places:
        for m in store.get_average_attention()[f"{place}_{'cross' if is_cross else 'self'}"]:
            if m.shape[-2] == num_pixels:
                maps.append(m.reshape(-1, res, res, m.shape[-1]))
    if not maps:
        raise ValueError(f"no attention maps captured at {res}x{res}")
    return torch.cat(maps, dim=0).mean(dim=0)


# -- word / alpha schedules ---------------------------------------------------

def update_alpha_time_word(alpha: np.ndarray,
                           bounds: Union[float, Tuple[float, float]],
                           prompt_ind: int,
                           word_inds: Optional[np.ndarray] = None) -> np.ndarray:
    if isinstance(bounds, (int, float)):
        bounds = (0.0, float(bounds))
    start, end = int(bounds[0] * alpha.shape[0]), int(bounds[1] * alpha.shape[0])
    if word_inds is None:
        word_inds = np.arange(alpha.shape[2])
    alpha[:start, prompt_ind, word_inds] = 0
    alpha[start:end, prompt_ind, word_inds] = 1
    alpha[end:, prompt_ind, word_inds] = 0
    return alpha


def get_time_words_attention_alpha(prompts, num_steps,
                                   cross_replace_steps, tokenizer,
                                   max_num_words: int = 77) -> np.ndarray:
    """Per-(step, prompt, token) alpha schedule controlling when cross
    attention is replaced during an edit."""
    if not isinstance(cross_replace_steps, dict):
        cross_replace_steps = {"default_": cross_replace_steps}
    if "default_" not in cross_replace_steps:
        cross_replace_steps["default_"] = (0.0, 1.0)
    alpha = np.zeros((num_steps + 1, len(prompts) - 1, max_num_words), np.float32)
    for i in range(len(prompts) - 1):
        alpha = update_alpha_time_word(alpha, cross_replace_steps["default_"], i)
    for key, item in cross_replace_steps.items():
        if key == "default_":
            continue
        for i, prompt in enumerate(prompts[1:]):
            inds = get_word_inds(prompt, key, tokenizer)
            if len(inds):
                alpha = update_alpha_time_word(alpha, item, i, inds)
    return alpha.reshape(num_steps + 1, len(prompts) - 1, 1, 1, max_num_words)
