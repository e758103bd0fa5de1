"""safetensors reader and writer in plain Python over torch tensors.

The format: an 8-byte little-endian header length N, N bytes of JSON
`{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__"?}`
(the writer pads it with spaces to a multiple of 8), then the data section,
each tensor's bytes at [begin, end) relative to its start, row-major and
little-endian. The reader returns tensors that share one buffer with the file
contents (`torch.frombuffer`), so bf16 needs no numpy dtype.
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def load_file(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """Read a .safetensors file into {name: CPU tensor}. Raises ValueError on
    a malformed or truncated file, or a dtype outside `DTYPES`."""
    path = Path(path)
    data = bytearray(path.stat().st_size)
    with open(path, "rb") as f:
        got = f.readinto(data)
    if got != len(data) or len(data) < 8:
        raise ValueError(f"{path}: file too short for a safetensors header")
    (n,) = struct.unpack("<Q", bytes(data[:8]))
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    try:
        header = json.loads(bytes(data[8 : 8 + n]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    start, size = 8 + n, len(data) - 8 - n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = info.get("dtype")
        if dt not in DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {dt}")
        dtype, shape = DTYPES[dt], [int(d) for d in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        itemsize = _itemsize(dtype)
        count = math.prod(shape)
        if end - begin != count * itemsize or begin < 0:
            raise ValueError(f"{path}: tensor {name} spans {end - begin} bytes, "
                             f"its shape {shape} x {itemsize} needs {count * itemsize}")
        if end > size:
            raise ValueError(f"{path}: tensor {name} runs past the end of the data "
                             f"({end} > {size} bytes)")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        offset = start + begin
        buf = data
        if offset % itemsize:  # an unaligned tensor gets its own aligned copy
            buf, offset = bytearray(data[offset : offset + count * itemsize]), 0
        out[name] = torch.frombuffer(buf, dtype=dtype, count=count, offset=offset).reshape(shape)
    return out


def save_file(tensors: Dict[str, Union[torch.Tensor, np.ndarray]], path: Union[str, Path],
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write {name: tensor} as a .safetensors file, tensors in the given
    order, contiguous in the data section."""
    entries, header, offset = [], {}, 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name, t in tensors.items():
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        t = t.detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name}: unsupported dtype {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        entries.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in entries:
            f.write(raw)
