"""The launch plan of the two split-KV decode kernels that share a core.

Counterpart, on the host, of ``csrc/decode_split.cuh``: the core of
``tree_decode.cu`` (B5) and of the rows path of ``flash_fwd.cu`` (B1 at
T <= 4), which carries the design of ``paged_decode.cu`` (B4; its plan,
``paged_plan``, keeps its own figures). Each kernel splits the keys of a
(row group, head) pair over ``splits`` blocks, from static shapes only
(never from tree bases or a key mask, which only the device reads), so a
call needs no host sync and a CUDA graph can hold it. The plans
(``tree_plan``, ``flash_rows_plan``) build on ``items_per_split`` and
``smem_bytes``; ``chip_smoke.py`` holds their threads and shared bytes
to the kernels' own.
"""

THREADS = 128       # threads a block
CHUNK = 32          # keys staged per chunk
MAX_ROWS = 8        # query rows one walk carries
STAGES = 3          # stage buffers of the ring (kRowsStages in the core)
# blocks a call aims at per SM (paged_plan aims at 4): one split at the
# main shapes (256 (row group, head) pairs), four where one sequence or 4
# slots leave SMs idle. chip_smoke.py times both against another split
# (its ``split`` lines): on an H100 one split beat three at the main
# shapes, and four beat one at the small ones
BLOCKS_PER_SM = 1


def rows_for(n):
    """The rows a block carries through one walk for ``n`` query rows:
    1, 2, 4 or 8 (more than 8 walk again per group of 8)."""
    return 1 if n <= 1 else 2 if n <= 2 else 4 if n <= 4 else MAX_ROWS


def smem_bytes(dh, rows):
    """Shared bytes of a block at head dim ``dh`` carrying ``rows`` rows:
    ``STAGES`` buffers of K and V chunks of ``CHUNK`` rows of dh rounded
    up to 4 (or, where larger, the key groups' float4 sums of every row,
    which reuse them), the chunk's scores and the warps' sums of each
    row."""
    dhp = -(-dh // 4) * 4
    ring = STAGES * 2 * CHUNK * dhp
    return 4 * (max(ring, rows * THREADS * 4) + rows * CHUNK
                + rows * (THREADS // 32))


def items_per_split(units, n_items, item_keys, n_sm):
    """Items (pages, or chunks of ``CHUNK`` keys) of ``item_keys`` keys
    each per split, over ``n_items`` items of each of ``units`` (row
    group, head) pairs, by ``paged_plan``'s rule: aims at
    ``BLOCKS_PER_SM`` blocks an SM of ``n_sm``, with at least two staged
    chunks of keys a split where there is more than one (the ring has
    something to overlap)."""
    want = -(-BLOCKS_PER_SM * n_sm // units)
    most = max(1, n_items * item_keys // (2 * CHUNK))
    return -(-n_items // max(1, min(want, most, n_items)))


def check_smem(who, smem, smem_limit):
    if smem > smem_limit:
        raise ValueError("%s: %d bytes of shared memory a block exceed the "
                         "limit %d" % (who, smem, smem_limit))
