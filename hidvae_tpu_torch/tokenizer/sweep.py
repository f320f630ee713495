"""Chunked corpus sweep (counterpart of hidvae_tpu/tokenizer/sweep.py):
pinned chunks uploaded on a side stream beside the previous encode; with
`mesh` each chunk split over the data ranks and gathered."""

import hashlib
from typing import Callable

import numpy as np
import torch

from hidvae_tpu_torch.parallel.collectives import all_gather_cat
from hidvae_tpu_torch.parallel.mesh import pad_to_multiple


def features_fingerprint(item_features) -> str:
    """SHA-1 of a feature matrix's shape and up to 64 evenly spaced rows,
    tying a table to its features; the JAX function's digest."""
    n = int(item_features.shape[0])
    take = min(n, 64)
    if take:
        idx = np.linspace(0, n - 1, take).astype(np.int64)
        if isinstance(item_features, torch.Tensor):
            rows = item_features[torch.from_numpy(idx).to(item_features.device)]
            rows = rows.detach().to("cpu", torch.float32).numpy()
        else:
            rows = np.asarray(item_features[idx], np.float32)
    else:
        rows = np.zeros((0,), np.float32)
    h = hashlib.sha1()
    h.update(repr(tuple(int(s) for s in item_features.shape)).encode())
    h.update(np.ascontiguousarray(rows).tobytes())
    return h.hexdigest()


def _sharded(encode_block, mesh):
    """encode_block on this data rank's part of each chunk, the parts
    gathered over the data group and the padding dropped."""
    def encode(block):
        padded, n = pad_to_multiple(block, mesh.n_data)
        part = padded.shape[0] // mesh.n_data
        mine = encode_block(padded[mesh.data_rank * part:(mesh.data_rank + 1) * part])
        return all_gather_cat(mine, mesh.data_group)[:n]
    return encode


def sweep_corpus(
    encode_block: Callable[[torch.Tensor], torch.Tensor],
    item_features,
    chunk_size: int,
    device: torch.device,
    mesh=None,
) -> torch.Tensor:
    """`encode_block` over `item_features` in chunks of `chunk_size` rows, concatenated;
    with `mesh` the data ranks split each chunk (sweep.py:67-68) and every rank returns the
    whole."""
    n = int(item_features.shape[0])
    chunk = min(chunk_size, n)
    if isinstance(item_features, torch.Tensor):
        feats = item_features.float()
    else:
        feats = torch.from_numpy(np.ascontiguousarray(item_features, np.float32))
    if mesh is not None and mesh.n_data > 1:
        chunk += (-chunk) % mesh.n_data
        encode_block = _sharded(encode_block, mesh)
    starts = range(0, n, chunk)
    if feats.device == device or device.type != "cuda":
        return torch.cat([encode_block(feats[s:s + chunk].to(device)) for s in starts])

    main = torch.cuda.current_stream(device)
    copy_stream = torch.cuda.Stream(device)

    def stage(start):
        # The pinned staging buffer must outlive its asynchronous copy: it is
        # kept beside the device block until that block has been consumed.
        host = feats[start:start + chunk].pin_memory()
        with torch.cuda.stream(copy_stream):
            block = host.to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return block, ready, host

    out = []
    pending = stage(starts[0])
    for i in range(len(starts)):
        block, ready, _host = pending
        if i + 1 < len(starts):
            pending = stage(starts[i + 1])  # upload the next chunk meanwhile
        main.wait_event(ready)
        block.record_stream(main)
        out.append(encode_block(block))
    return torch.cat(out)
