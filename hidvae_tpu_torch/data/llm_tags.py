"""Tag completion of a partly tagged corpus (counterpart of
hidvae_tpu/data/llm_tags.py): an OpenAI-compatible endpoint pool, the
deterministic route (L1 -> L2 -> L3 by cosine retrieval among the parent's
children) and the LLM route with a resumable journal; host numpy, bit for
bit the JAX module's."""

import json
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger("hidvae_tpu_torch.data.llm_tags")


@dataclass
class LLMEndpoint:
    base_url: str
    api_key: str = "EMPTY"
    model: str = "qwen"
    in_flight: int = 0


class LLMPool:
    """Thread-safe pool of endpoints, picked least-used or round-robin."""

    def __init__(self, endpoints: Sequence[LLMEndpoint], *, strategy: str = "least_used",
                 max_retries: int = 3, retry_delay: float = 1.0):
        if not endpoints:
            raise ValueError(
                "LLMPool needs at least one endpoint; this environment has no "
                "network egress — use complete_tags_hierarchical (the "
                "deterministic route) instead."
            )
        self.endpoints = list(endpoints)
        self.strategy = strategy
        self.max_retries = max_retries
        self.retry_delay = retry_delay
        self._lock = threading.Lock()
        self._rr = 0

    def _pick(self) -> LLMEndpoint:
        with self._lock:
            if self.strategy == "round_robin":
                ep = self.endpoints[self._rr % len(self.endpoints)]
                self._rr += 1
            else:
                ep = min(self.endpoints, key=lambda e: e.in_flight)
            ep.in_flight += 1
            return ep

    def _release(self, ep: LLMEndpoint):
        with self._lock:
            ep.in_flight = max(0, ep.in_flight - 1)

    def chat(self, messages: List[dict], *, temperature: float = 0.2, parse_json: bool = True):
        """One POST to <base_url>/chat/completions, retried max_retries times
        (sleeping retry_delay * attempt); the reply's JSON object or text."""
        import urllib.request

        last_err = None
        for attempt in range(self.max_retries):
            ep = self._pick()
            try:
                body = json.dumps({"model": ep.model, "messages": messages,
                                   "temperature": temperature}).encode()
                req = urllib.request.Request(
                    ep.base_url.rstrip("/") + "/chat/completions", data=body,
                    headers={"Content-Type": "application/json",
                             "Authorization": f"Bearer {ep.api_key}"})
                with urllib.request.urlopen(req, timeout=120) as resp:
                    out = json.loads(resp.read())
                text = out["choices"][0]["message"]["content"]
                return _extract_json(text) if parse_json else text
            except Exception as e:  # noqa: BLE001 — any transport error is retried
                last_err = e
                logger.warning(f"LLM call failed (attempt {attempt + 1}): {e}")
                time.sleep(self.retry_delay * (attempt + 1))
            finally:
                self._release(ep)
        raise RuntimeError(f"LLM pool exhausted retries: {last_err}")

    def chat_batch(self, message_lists: List[List[dict]], *, max_workers: int = 8, **kw):
        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            futures = [ex.submit(self.chat, m, **kw) for m in message_lists]
            return [f.result() for f in futures]


def _extract_json(text: str):
    """The first '{' to the last '}' of a reply, parsed."""
    start, end = text.find("{"), text.rfind("}")
    if start == -1 or end == -1:
        raise ValueError(f"No JSON object in LLM reply: {text[:200]!r}")
    return json.loads(text[start:end + 1])


def build_tag_hierarchy(tags_indices: np.ndarray) -> Dict[str, Dict[int, List[int]]]:
    """{"l1_to_l2", "l2_to_l3"}: each parent's sorted children, as observed."""
    l1_to_l2: Dict[int, set] = {}
    l2_to_l3: Dict[int, set] = {}
    for l1, l2, l3 in np.asarray(tags_indices):
        if l1 != -1 and l2 != -1:
            l1_to_l2.setdefault(int(l1), set()).add(int(l2))
        if l2 != -1 and l3 != -1:
            l2_to_l3.setdefault(int(l2), set()).add(int(l3))
    return {"l1_to_l2": {k: sorted(v) for k, v in l1_to_l2.items()},
            "l2_to_l3": {k: sorted(v) for k, v in l2_to_l3.items()}}


def build_tag_pools(tags_indices: np.ndarray, tags_emb: np.ndarray):
    """Per level (ids [K_l] int32, unit-norm mean embeddings [K_l, D]) of
    the items carrying each tag."""
    pools = []
    for level in range(tags_indices.shape[1]):
        ids = np.unique(tags_indices[:, level])
        ids = ids[ids >= 0]
        embs = np.zeros((len(ids), tags_emb.shape[-1]), np.float32)
        for j, tag in enumerate(ids):
            embs[j] = tags_emb[tags_indices[:, level] == tag, level].mean(axis=0)
        embs /= np.maximum(np.linalg.norm(embs, axis=-1, keepdims=True), 1e-8)
        pools.append((ids.astype(np.int32), embs))
    return pools


def _retrieve(context, pool_ids, pool_embs, candidates: Optional[List[int]]):
    """(id, embedding) of the pool's tag most cosine-similar to `context`,
    among `candidates` when given; (None, None) when none is in the pool."""
    c = context / max(np.linalg.norm(context), 1e-8)
    if candidates is not None:
        mask = np.isin(pool_ids, candidates)
        if not mask.any():
            return None, None
        pool_ids, pool_embs = pool_ids[mask], pool_embs[mask]
    j = int(np.argmax(pool_embs @ c))
    return int(pool_ids[j]), pool_embs[j]


def _unit(v):
    return v / max(np.linalg.norm(v), 1e-8)


def complete_tags_hierarchical(item_features: np.ndarray, tags_indices: np.ndarray,
                               tags_emb: np.ndarray) -> np.ndarray:
    """Every -1 filled where it can be: L1 by global retrieval; L2 among the
    L1 parent's children by 0.6 L1 + 0.4 item; L3 among the L2 parent's by
    0.5 L2 + 0.3 L1 + 0.2 item; no children: the level's pool."""
    tags = np.asarray(tags_indices).copy()
    hierarchy = build_tag_hierarchy(tags)
    pools = build_tag_pools(tags, tags_emb)
    for i in range(len(tags)):
        if (tags[i] != -1).all():
            continue
        item_emb = _unit(item_features[i])
        lvl_emb = {l: _unit(tags_emb[i, l]) for l in range(3) if tags[i, l] != -1}
        if tags[i, 0] == -1:
            tid, emb = _retrieve(item_emb, *pools[0], None)
            if tid is not None:
                tags[i, 0], lvl_emb[0] = tid, emb
        for l, parents in ((1, "l1_to_l2"), (2, "l2_to_l3")):
            if tags[i, l] != -1 or tags[i, l - 1] == -1:
                continue
            candidates = hierarchy[parents].get(int(tags[i, l - 1]))
            l1e = lvl_emb.get(0, item_emb)
            context = (0.6 * l1e + 0.4 * item_emb if l == 1 else
                       0.5 * lvl_emb.get(1, item_emb) + 0.3 * l1e + 0.2 * item_emb)
            tid, emb = _retrieve(context, *pools[l], candidates)
            if tid is None:
                tid, emb = _retrieve(context, *pools[l], None)
            if tid is not None:
                tags[i, l], lvl_emb[l] = tid, emb
    return tags


def completion_prompt(item_text: str, known_tags: Dict[int, str],
                      candidates: Dict[int, List[str]]) -> List[dict]:
    """The chat messages asking for each missing level's tag as JSON."""
    payload = {
        "item": item_text,
        "known_tags": {f"level_{k + 1}": v for k, v in known_tags.items()},
        "candidates": {f"level_{k + 1}": v for k, v in candidates.items()},
        "instruction": (
            "Pick the best tag for each missing level from the candidates. "
            'Reply with JSON: {"level_1": ..., "level_2": ..., "level_3": ...}'
        ),
    }
    return [
        {"role": "system",
         "content": "You complete hierarchical category tags for short-video items."},
        {"role": "user", "content": json.dumps(payload, ensure_ascii=False)},
    ]


def load_completion_progress(progress_path: str) -> Dict[int, List[int]]:
    """{row: tags} of a `complete_tags_llm` journal; torn records are skipped."""
    done: Dict[int, List[int]] = {}
    if not os.path.exists(progress_path):
        return done
    with open(progress_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                done[int(rec["row"])] = [int(t) for t in rec["tags"]]
            except (ValueError, KeyError, TypeError):
                logger.warning(f"skipping torn progress record: {line[:80]!r}")
    return done


def complete_tags_llm(pool: LLMPool, item_texts: Sequence[str], tags_indices: np.ndarray,
                      vocabs: Sequence[Sequence[str]], tags_emb: np.ndarray,
                      item_features: np.ndarray, *, top_k_candidates: int = 10,
                      max_workers: int = 8, progress_path: Optional[str] = None) -> np.ndarray:
    """Ask `pool` for each incomplete row's missing levels among its top-k
    cosine candidates, failures falling to complete_tags_hierarchical; with
    `progress_path` a jsonl journal of answers, replayed by a rerun."""
    tags = np.asarray(tags_indices).copy()
    done = load_completion_progress(progress_path) if progress_path else {}
    for i, row_tags in done.items():
        if 0 <= i < len(tags):
            tags[i] = row_tags
    if done:
        logger.info(f"resuming LLM tag completion: {len(done)} rows already journaled "
                    f"at {progress_path}")

    pools = build_tag_pools(tags, tags_emb)
    needs = [int(i) for i in np.nonzero((tags == -1).any(axis=1))[0] if int(i) not in done]
    prompts = {}
    for i in needs:
        known = {l: vocabs[l][tags[i, l]] for l in range(3) if tags[i, l] != -1}
        cands = {}
        item_emb = item_features[i] / max(np.linalg.norm(item_features[i]), 1e-8)
        for l in range(3):
            if tags[i, l] == -1:
                ids, embs = pools[l]
                top = ids[np.argsort(-(embs @ item_emb))[:top_k_candidates]]
                cands[l] = [vocabs[l][t] for t in top]
        prompts[i] = completion_prompt(item_texts[i], known, cands)

    lookup = [{t: j for j, t in enumerate(v)} for v in vocabs]
    journal = open(progress_path, "a") if progress_path else None
    try:
        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            futures = {ex.submit(pool.chat, p): i for i, p in prompts.items()}
            for fut in as_completed(futures):
                i = futures[fut]
                try:
                    reply = fut.result()
                    for l in range(3):
                        if tags[i, l] == -1:
                            name = reply.get(f"level_{l + 1}")
                            if name in lookup[l]:
                                tags[i, l] = lookup[l][name]
                except Exception as e:  # noqa: BLE001 — the row falls to the deterministic route
                    logger.warning(f"LLM completion failed for row {i}: {e}")
                    continue
                if journal is not None:
                    journal.write(json.dumps({"row": i, "tags": [int(t) for t in tags[i]]})
                                  + "\n")
                    journal.flush()
    finally:
        if journal is not None:
            journal.close()
    if (tags == -1).any():
        tags = complete_tags_hierarchical(item_features, tags, tags_emb)
    return tags


def fill_empty_titles(item_texts: Sequence[str], tags_indices: np.ndarray,
                      vocabs: Sequence[Sequence[str]]) -> List[str]:
    """A new list: each empty or blank title replaced by the item's valid tag
    names joined by spaces (kept empty when it has none)."""
    out = list(item_texts)
    filled = 0
    for i, text in enumerate(out):
        if text is not None and str(text).strip():
            continue
        names = [vocabs[l][t] for l, t in enumerate(tags_indices[i])
                 if 0 <= int(t) < len(vocabs[l]) and str(vocabs[l][t]).strip()]
        if names:
            out[i] = " ".join(names)
            filled += 1
    logger.info(f"fill_empty_titles: filled {filled} empty titles out of {len(out)} items")
    return out
