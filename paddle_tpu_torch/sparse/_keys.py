"""Index arithmetic of the sparse package, on the tensors' device.

Coordinates become linear keys in int64 (a KITTI-sized voxel grid times a
batch is past 2**31 cells once channels or a batch multiply in), keys
become coordinates again, and a CSR row pointer gives each entry's row
by a search. Nothing here reads a value to the host.

A size that the data decides (how many distinct coordinates, how many
pairs a kernel offset finds) has to reach the host to allocate the
result: :func:`host_sizes` is the one way the package reads one, and it
counts each read in ``syncs`` (phase 66 of ``chip_smoke.py`` holds the
profiler's device-to-host copies to it).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

syncs = 0   # host reads of data-decided sizes since import


def host_sizes(t: torch.Tensor) -> List[int]:
    """``t`` (an integer tensor of sizes) as Python ints: one counted
    device-to-host read."""
    global syncs
    syncs += 1
    return [int(v) for v in t.reshape(-1).tolist()]


def host_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two index tensors are equal: one counted host read."""
    global syncs
    syncs += 1
    return bool(torch.equal(a, b))


def counted_unique(keys: torch.Tensor, return_inverse: bool = False):
    """``torch.unique(keys, sorted=True)``: the count of distinct keys is
    a size the data decides, read once by the op itself (counted)."""
    global syncs
    syncs += 1
    return torch.unique(keys, sorted=True, return_inverse=return_inverse)


def linearize(idx: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """Row-major int64 keys of the coordinates ``idx [len(dims), n]``."""
    key = idx[0].long()
    for d in range(1, len(dims)):
        key = key * int(dims[d]) + idx[d].long()
    return key


def unravel(keys: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """The coordinates ``[len(dims), n]`` (int32) of int64 ``keys``."""
    rows = []
    for d in reversed([int(s) for s in dims]):
        rows.append(torch.remainder(keys, d))
        keys = torch.div(keys, d, rounding_mode="floor")
    return torch.stack(rows[::-1]).to(torch.int32)


def csr_rows(crows: torch.Tensor, nnz: int) -> torch.Tensor:
    """The row of each of the ``nnz`` entries of a 2-D CSR pattern."""
    pos = torch.arange(nnz, device=crows.device, dtype=torch.long)
    return torch.searchsorted(crows[1:].long(), pos, right=True)


def csr_pattern(crows: torch.Tensor, cols: torch.Tensor, n: int, rows: int,
                width: int) -> torch.Tensor:
    """The dense boolean pattern ``[n, rows, width]`` of a batch of ``n``
    CSR matrices: ``crows`` ``[n * (rows + 1)]``, ``cols`` every matrix's
    columns one after another. Each matrix's offsets may start at 0 (as
    Paddle lays them out) or continue from the one before (as the
    reference reads them); both place its entries the same."""
    cr = crows.long().reshape(n, rows + 1)
    local = cr - cr[:, :1]
    start = torch.cumsum(local[:, -1], 0) - local[:, -1]   # exclusive
    ptr = torch.cat([(local[:, :rows] + start[:, None]).reshape(-1),
                     (start[-1:] + local[-1:, -1])])
    nnz = cols.numel()
    row = csr_rows(ptr, nnz)                # in [0, n * rows)
    mask = torch.zeros(n * rows, width, dtype=torch.bool,
                       device=cols.device)
    mask[row, cols.long()] = True
    return mask.reshape(n, rows, width)
