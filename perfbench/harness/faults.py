"""Faults planted in the port underneath a run, for the tests and the chip
readings that show the comparison catches them. Each takes the kind's
program objects and patches them in place (instance attributes only)."""

import torch

from hidvae_tpu_torch.data.schemas import TokenizedSeqBatch


def _rows(batch: TokenizedSeqBatch, n: int) -> TokenizedSeqBatch:
    return batch.replace(**{name: None if t is None else t[:n]
                            for name, t in vars(batch).items()})


def serve_token(objs):
    """One digit of one served tuple altered where the step produces it."""
    engine = objs["engine"]
    step = engine._rows_step

    def altered(user_ids, items):
        idx, sids, scores = step(user_ids, items)
        sids = sids.clone()
        sids[0, 0, -1] = (sids[0, 0, -1] + 1) % engine.model.num_embeddings
        return idx, sids, scores

    engine._rows_step = altered


def serve_half(objs):
    """The second half of each page left out: its rows answered with the
    first half's answers."""
    engine = objs["engine"]
    step = engine._rows_step

    def half(user_ids, items):
        b = items.shape[0] // 2
        out = step(user_ids[:b], items[:b])
        return tuple(torch.cat([t, t]) for t in out)

    engine._rows_step = half


def train_unchanged(objs):
    """The step returns the state unchanged: no update is applied."""
    objs["optimizer"].step = lambda: False


def train_half(objs):
    """Half of the batch left out, the loss the mean over the rest."""
    model = objs["model"]
    forward = model.forward

    def half(batch, generator=None):
        return forward(_rows(batch, batch.sem_ids.shape[0] // 2), generator)

    model.forward = half


def train_token(objs):
    """One target token of each batch altered as the model receives it."""
    model = objs["model"]
    forward = model.forward

    def altered(batch, generator=None):
        fut = batch.sem_ids_fut.clone()
        fut[0, 0] = (fut[0, 0] + 1) % model.num_embeddings
        return forward(batch.replace(sem_ids_fut=fut), generator)

    model.forward = altered


FAULTS = {"serve": {"token": serve_token, "half": serve_half},
          "train": {"unchanged": train_unchanged, "half": train_half, "token": train_token}}
