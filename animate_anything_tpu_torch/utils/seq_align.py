"""Token-sequence alignment for prompt-to-prompt editing.

Capability parity with the reference's ``utils/seq_aligner.py`` (a vendored
Google prompt-to-prompt helper; inventoried in SURVEY §2.1): Needleman-Wunsch
global alignment between two tokenized prompts, and the mapper matrices
prompt-to-prompt editing consumes:

- ``get_refinement_mapper`` — per-token index map + alpha (1 where the source
  prompt has a matching token) for *refinement* edits;
- ``get_replacement_mapper`` — (max_len, max_len) soft permutation for
  *replacement* edits of equal-word-count prompts;
- ``get_word_inds`` — word → token-index resolution.

Pure numpy (host-side preprocessing — this never runs on the device; the mappers
it produces feed the attention controllers in utils/ptp.py).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

GAP, MATCH, MISMATCH = 0, 1, -1


def global_align(x: Sequence[int], y: Sequence[int],
                 gap: int = GAP, match: int = MATCH, mismatch: int = MISMATCH,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Needleman-Wunsch DP. Returns (score matrix, traceback matrix) where
    traceback codes are 1=left(insert in y), 2=up(delete from x), 3=diag."""
    nx, ny = len(x), len(y)
    score = np.zeros((nx + 1, ny + 1), np.int32)
    score[0, 1:] = (np.arange(ny) + 1) * gap
    score[1:, 0] = (np.arange(nx) + 1) * gap
    trace = np.zeros((nx + 1, ny + 1), np.int32)
    trace[0, 1:] = 1
    trace[1:, 0] = 2
    trace[0, 0] = 4
    xa = np.asarray(x)
    ya = np.asarray(y)
    for i in range(1, nx + 1):
        # vectorized over j is impossible (left depends on j-1); row-wise scan
        sub = np.where(ya == xa[i - 1], match, mismatch)
        for j in range(1, ny + 1):
            left = score[i, j - 1] + gap
            up = score[i - 1, j] + gap
            diag = score[i - 1, j - 1] + sub[j - 1]
            best = max(left, up, diag)
            score[i, j] = best
            trace[i, j] = 1 if best == left else (2 if best == up else 3)
    return score, trace


def aligned_sequences(x: Sequence[int], y: Sequence[int], trace: np.ndarray
                      ) -> Tuple[list, list, np.ndarray]:
    """Walk the traceback; returns (x aligned, y aligned, y→x index pairs
    with -1 for y tokens that have no x counterpart)."""
    x_seq: list = []
    y_seq: list = []
    i, j = len(x), len(y)
    mapper: List[Tuple[int, int]] = []
    while i > 0 or j > 0:
        t = trace[i, j]
        if t == 3:
            x_seq.append(x[i - 1]); y_seq.append(y[j - 1])
            i -= 1; j -= 1
            mapper.append((j, i))
        elif t == 1:
            x_seq.append(None); y_seq.append(y[j - 1])
            j -= 1
            mapper.append((j, -1))
        elif t == 2:
            x_seq.append(x[i - 1]); y_seq.append(None)
            i -= 1
        else:
            break
    mapper.reverse()
    return x_seq[::-1], y_seq[::-1], np.asarray(mapper, np.int64).reshape(-1, 2)


def get_mapper(x: str, y: str, tokenizer, max_len: int = 77
               ) -> Tuple[np.ndarray, np.ndarray]:
    """y-token → x-token index map (padded with identity past the prompt) and
    alphas (0 where the y token is new relative to x)."""
    x_seq = list(tokenizer.encode(x))
    y_seq = list(tokenizer.encode(y))
    _, trace = global_align(x_seq, y_seq)
    pairs = aligned_sequences(x_seq, y_seq, trace)[2]
    n = pairs.shape[0]
    alphas = np.ones(max_len, np.float32)
    alphas[:n] = (pairs[:, 1] != -1).astype(np.float32)
    mapper = np.zeros(max_len, np.int64)
    mapper[:n] = pairs[:, 1]
    mapper[n:] = len(y_seq) + np.arange(max_len - len(y_seq))[: max_len - n]
    return mapper, alphas


def get_refinement_mapper(prompts: Sequence[str], tokenizer, max_len: int = 77
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked mappers/alphas from prompts[0] to each later prompt."""
    mappers, alphas = [], []
    for p in prompts[1:]:
        m, a = get_mapper(prompts[0], p, tokenizer, max_len)
        mappers.append(m)
        alphas.append(a)
    return np.stack(mappers), np.stack(alphas)


def get_word_inds(text: str, word_place: Union[int, str], tokenizer) -> np.ndarray:
    """Token indices (1-based, past BOS) covering the given word (by position
    or literal match)."""
    words = text.split(" ")
    if isinstance(word_place, str):
        places = [i for i, w in enumerate(words) if w == word_place]
    else:
        places = [int(word_place)]
    out: List[int] = []
    if places:
        pieces = [tokenizer.decode([t]).strip("#") for t in tokenizer.encode(text)][1:-1]
        cur_len, ptr = 0, 0
        for i, piece in enumerate(pieces):
            cur_len += len(piece)
            if ptr in places:
                out.append(i + 1)
            if ptr < len(words) and cur_len >= len(words[ptr]):
                ptr += 1
                cur_len = 0
    return np.asarray(out, np.int64)


def get_replacement_mapper_(x: str, y: str, tokenizer, max_len: int = 77) -> np.ndarray:
    """Soft (max_len, max_len) map distributing source-token attention onto
    target tokens for word replacements; identity elsewhere."""
    words_x = x.split(" ")
    words_y = y.split(" ")
    if len(words_x) != len(words_y):
        raise ValueError(
            "attention replacement edits need prompts with the same word count"
            f" ({len(words_x)} vs {len(words_y)})"
        )
    replaced = [i for i in range(len(words_y)) if words_y[i] != words_x[i]]
    inds_src = [get_word_inds(x, i, tokenizer) for i in replaced]
    inds_tgt = [get_word_inds(y, i, tokenizer) for i in replaced]
    mapper = np.zeros((max_len, max_len), np.float32)
    i = j = cur = 0
    while i < max_len and j < max_len:
        if cur < len(inds_src) and len(inds_src[cur]) and inds_src[cur][0] == i:
            s, t = inds_src[cur], inds_tgt[cur]
            if len(s) == len(t):
                mapper[s, t] = 1.0
            else:
                for ti in t:
                    mapper[s, ti] = 1.0 / len(t)
            i += len(s)
            j += len(t)
            cur += 1
        elif cur < len(inds_src):
            mapper[i, j] = 1.0
            i += 1
            j += 1
        else:
            mapper[j, j] = 1.0
            i += 1
            j += 1
    return mapper


def get_replacement_mapper(prompts: Sequence[str], tokenizer, max_len: int = 77
                           ) -> np.ndarray:
    return np.stack([get_replacement_mapper_(prompts[0], p, tokenizer, max_len)
                     for p in prompts[1:]])
