"""Plain PyTorch building block of the kernels' plain versions and of the
``bitmap`` engine: the forbidden-color table and its first clear slot.

torch has no uint32 shifts or min on the CPU, so the table holds one byte
per color slot (the unpacked view of the kernels' uint32 bitset): a
``[rows, 32·W]`` uint8 table plus one sink row and one sink column that
absorb inert and out-of-range entries.
"""
from __future__ import annotations

import torch

_INT32_MAX = torch.iinfo(torch.int32).max


def table_mex(rows: torch.Tensor, cols: torch.Tensor, num_rows: int,
              num_colors: int) -> torch.Tensor:
    """Per row, the smallest color in ``[1, num_colors)`` that no
    ``(rows[i], cols[i])`` pair forbids; ``INT32_MAX`` if all are forbidden.

    rows: int indices in ``[0, num_rows]`` (``num_rows`` = inert sink row);
    cols: int colors, any value — those outside ``[0, num_colors)`` drop
    (they land in the sink column). Color 0 is always forbidden.
    Returns ``[num_rows]`` int32."""
    C = int(num_colors)
    col = torch.where((cols >= 0) & (cols < C), cols, torch.full_like(cols, C))
    table = torch.zeros((num_rows + 1, C + 1), dtype=torch.uint8,
                        device=cols.device)
    table[rows.long(), col.long()] = 1
    free = table[:num_rows, :C] == 0
    free[:, 0] = False
    first = free.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return torch.where(free.any(dim=1), first,
                       torch.full_like(first, _INT32_MAX))
