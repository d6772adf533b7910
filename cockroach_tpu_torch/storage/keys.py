"""Fixed-width key encoding for device-resident KV blocks.

Keys are zero-padded fixed-width byte rows ([N, KW] uint8) whose
big-endian 64-bit "word lanes" compare in the same lexicographic order as
the raw bytes (as in ``cockroach_tpu.storage.keys``).

The 64-bit convention of the port, set here once: torch has no usable
unsigned 64-bit compare or shift, so a key word is carried as an int64
holding the word's bit pattern.

- order: flip bit 63 (``x ^ INT64_MIN``), then compare signed — this is
  the unsigned order of the bit patterns;
- equality: plain int64 equality;
- logical shifts: ``(x >> k) & mask``.

Host-side bounds stay numpy uint64 word vectors, as in the reference;
``words_tensor`` turns one into the int64 device form.
"""

from __future__ import annotations

import numpy as np
import torch

from ..coldata.batch import pack_be_words

DEFAULT_KEY_WIDTH = 24  # 3 word lanes

INT64_MIN = -(1 << 63)


def flip(x: torch.Tensor) -> torch.Tensor:
    """int64 word bit patterns -> int64 values whose signed order is the
    words' unsigned order."""
    return x ^ INT64_MIN


def encode_keys(keys: list[bytes | str], width: int = DEFAULT_KEY_WIDTH
                ) -> np.ndarray:
    """Host: list of byte/str keys -> [N, width] uint8, zero padded."""
    out = np.zeros((len(keys), width), dtype=np.uint8)
    for i, k in enumerate(keys):
        b = k.encode("utf-8") if isinstance(k, str) else bytes(k)
        if len(b) > width:
            raise ValueError(f"key longer than key width {width}: {b!r}")
        out[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return out


def decode_keys(arr: np.ndarray) -> list[bytes]:
    """Host: [N, width] uint8 -> raw bytes with zero padding stripped."""
    a = np.asarray(arr, dtype=np.uint8)
    if a.size == 0:
        return []
    nz = a[:, ::-1] != 0
    lens = np.where(nz.any(axis=1), a.shape[1] - nz.argmax(axis=1), 0)
    data = a.tobytes()
    w = a.shape[1]
    return [data[i * w: i * w + ln] for i, ln in enumerate(lens)]


def key_words(key: torch.Tensor) -> torch.Tensor:
    """[N, KW] uint8 -> [N, KW//8] int64 word lanes (bit patterns)."""
    if key.shape[1] % 8:
        raise ValueError("key width must be a multiple of 8")
    return pack_be_words(key)


def words_cmp_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic unsigned a < b over trailing [..., W] word lanes
    (broadcasting) -> [...] bool. Each lane votes +1 (a's word below b's),
    -1 (above) or 0, weighted 2^(W-1-i): the first differing lane
    outweighs all later ones, so the sum's sign is the comparison (a few
    whole-tensor operations rather than several per lane)."""
    fa, fb = flip(a), flip(b)
    vote = (fa < fb).to(torch.int64) - (fa > fb).to(torch.int64)
    w = a.shape[-1]
    weight = 2 ** torch.arange(w - 1, -1, -1, device=a.device)
    return (vote * weight).sum(-1) > 0


def words_cmp_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def words_in_range(words: torch.Tensor, start: torch.Tensor | None,
                   end: torch.Tensor | None) -> torch.Tensor:
    """start <= key < end over word lanes; start/end are [W] int64 word
    vectors, or None for unbounded."""
    ok = torch.ones(words.shape[:-1], dtype=torch.bool, device=words.device)
    if start is not None:
        ok = ok & ~words_cmp_lt(words, start)
    if end is not None:
        ok = ok & words_cmp_lt(words, end)
    return ok


def words_np(enc: np.ndarray) -> np.ndarray:
    """Host: [N, width] uint8 -> [N, width//8] uint64 big-endian words."""
    return np.ascontiguousarray(enc).view(">u8").astype(np.uint64)


def words_tensor(words: np.ndarray | None, device) -> torch.Tensor | None:
    """Host uint64 word vector(s) -> int64 bit patterns on `device`."""
    if words is None:
        return None
    w = np.ascontiguousarray(np.asarray(words, dtype=np.uint64))
    return torch.from_numpy(w.view(np.int64).copy()).to(device)


def encode_bound(key: bytes | str | None, width: int = DEFAULT_KEY_WIDTH):
    """Host: one scan bound -> [width//8] uint64 word vector, or None."""
    if key is None:
        return None
    return words_np(encode_keys([key], width))[0]


def encode_bounds(keys: list[bytes | str], width: int = DEFAULT_KEY_WIDTH):
    """Host: batch of scan bounds -> [N, width//8] uint64 word lanes."""
    return words_np(encode_keys(keys, width))


def bound_next(words: np.ndarray) -> np.ndarray:
    """Host: the word-lane successor of an encoded key — the exclusive end
    bound for a point lookup (+1 with carry; zero padding makes
    ``key + b"\\x00"`` encode identically to ``key``)."""
    out = np.array(words, dtype=np.uint64, copy=True)
    with np.errstate(over="ignore"):  # the carry wraps a word to 0
        for i in range(len(out) - 1, -1, -1):
            out[i] = out[i] + np.uint64(1)
            if out[i] != 0:
                break
    return out
