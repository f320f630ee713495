"""Tag completion in the port against the JAX module on the same seeded
inputs: hierarchy, pools, completion, prompt, titles, the journal (bytes at
one worker) and the pool, over HTTP to a loopback server too."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from hidvae_tpu.data import llm_tags as jt
from hidvae_tpu_torch.data import llm_tags as tt


def corpus(seed=0, n=80):
    """Features, complete tags of a 4 x 3 x 2 tree and their embeddings."""
    rng = np.random.RandomState(seed)
    leaf = rng.randint(0, 24, n)
    tags = np.stack([leaf // 6, leaf // 2, leaf], 1).astype(np.int32)
    feats = rng.randn(n, 8).astype(np.float32)  # the tags' width, as in KuaiRand
    emb = (rng.randn(3, 24, 8)[np.arange(3), tags] + 0.3 * rng.randn(n, 3, 8)).astype(np.float32)
    return feats, tags, emb


def holed(tags, seed=1):
    """~15 % holes a level; every item of L1 tag 3 loses its L2 (a parent
    without children: the global search) and some rows lose L1."""
    out = tags.copy()
    out[np.random.RandomState(seed).rand(*tags.shape) < 0.15] = -1
    out[tags[:, 0] == 3, 1] = -1
    out[:4, 0] = -1
    return out


def test_hierarchy_and_pools_equal_jax():
    _, tags, emb = corpus()
    h = holed(tags)
    assert tt.build_tag_hierarchy(h) == jt.build_tag_hierarchy(h)
    for (ti, te), (ji, je) in zip(tt.build_tag_pools(h, emb), jt.build_tag_pools(h, emb)):
        assert ti.dtype == ji.dtype and te.dtype == je.dtype
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(te, je)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_complete_tags_hierarchical_equals_jax(seed):
    feats, tags, emb = corpus(seed)
    h = holed(tags, seed + 1)
    assert 3 not in jt.build_tag_hierarchy(h)["l1_to_l2"] and (h[:, 0] == -1).any()
    out = tt.complete_tags_hierarchical(feats, h, emb)
    np.testing.assert_array_equal(out, jt.complete_tags_hierarchical(feats, h, emb))
    assert (out >= 0).all() and np.array_equal(out[h >= 0], h[h >= 0])


def test_prompt_titles_and_json_equal_jax(tmp_path):
    args = ("clip", {0: "food", 2: "x"}, {1: ["a", "b"]})
    assert tt.completion_prompt(*args) == jt.completion_prompt(*args)
    vocabs = [["food", "travel"], ["snacks", "asia", ""], ["x", "y"]]
    texts = ["keep me", "", "   ", None, ""]
    tags = np.array([[0, 0, 0], [1, 1, 1], [0, 2, -1], [-1, -1, -1], [1, -1, 0]], np.int32)
    assert tt.fill_empty_titles(texts, tags, vocabs) == jt.fill_empty_titles(texts, tags, vocabs)
    assert texts[1] == ""
    for text in ('ok {"level_1": "a"} tail', "{}"):
        assert tt._extract_json(text) == jt._extract_json(text)
    for mod in (tt, jt):
        with pytest.raises(ValueError, match="No JSON"):
            mod._extract_json("none")
        with pytest.raises(ValueError, match="deterministic"):
            mod.LLMPool([])
    # Torn records: truncated JSON, a missing key, null tags.
    path = tmp_path / "p.jsonl"
    path.write_text('{"row": 1, "tags": [1, 2, 3]}\n{"row": 2, "ta\n\n{"row": 3}\n'
                    '{"row": 4, "tags": null}\n{"row": 5, "tags": [0, 0, 1]}\n')
    assert tt.load_completion_progress(str(path)) == jt.load_completion_progress(str(path))
    assert tt.load_completion_progress(str(path)) == {1: [1, 2, 3], 5: [0, 0, 1]}
    assert tt.load_completion_progress(str(tmp_path / "none")) == {}


def test_pool_picking_equals_jax():
    picked = {}
    for mod in (tt, jt):
        for strategy in ("least_used", "round_robin"):
            pool = mod.LLMPool([mod.LLMEndpoint(f"u{i}") for i in range(3)], strategy=strategy)
            eps = [pool._pick() for _ in range(4)]
            pool._release(eps[0])
            eps.append(pool._pick())
            picked[mod, strategy] = ([e.base_url for e in eps],
                                     [e.in_flight for e in pool.endpoints])
    assert all(picked[tt, s] == picked[jt, s] for s in ("least_used", "round_robin"))


class AnswerPool:
    """Duck-typed pool answering from the truth; KeyboardInterrupt (a kill)
    after `kill_after` answers; RuntimeError (retries spent) for `failing`."""

    def __init__(self, tags, vocabs, kill_after=None, failing=()):
        self.tags, self.vocabs, self.kill_after, self.failing = tags, vocabs, kill_after, failing
        self.rows = []

    def chat(self, messages, **kw):
        row = int(json.loads(messages[1]["content"])["item"].split("-")[1])
        if self.kill_after is not None and len(self.rows) >= self.kill_after:
            raise KeyboardInterrupt("killed")
        self.rows.append(row)
        if row in self.failing:
            raise RuntimeError("LLM pool exhausted retries")
        return {f"level_{l + 1}": self.vocabs[l][self.tags[row, l]] for l in range(3)}


def test_complete_tags_llm_journal_equals_jax(tmp_path):
    """Killed after 4 answers, then resumed with a failing row: the same
    queried rows, journal bytes and output as JAX's at max_workers=1."""
    feats, tags, emb = corpus()
    h = holed(tags)
    vocabs = [[f"L{l}tag{k}" for k in range(24)] for l in range(3)]
    texts = [f"item-{i}" for i in range(len(tags))]
    got = {}
    for mod in (tt, jt):
        path = tmp_path / f"{mod.__name__}.jsonl"
        first = AnswerPool(tags, vocabs, kill_after=4)
        with pytest.raises(KeyboardInterrupt):
            mod.complete_tags_llm(first, texts, h, vocabs, emb, feats, max_workers=1,
                                  progress_path=str(path))
        done = mod.load_completion_progress(str(path))
        assert set(done) == set(first.rows) and len(done) == 4
        failed = min(set(np.nonzero((h == -1).any(1))[0].tolist()) - set(done))
        second = AnswerPool(tags, vocabs, failing=(failed,))
        out = mod.complete_tags_llm(second, texts, h, vocabs, emb, feats, max_workers=1,
                                    progress_path=str(path))
        assert failed in second.rows and not set(second.rows) & set(done)
        assert failed not in mod.load_completion_progress(str(path))
        got[mod] = (first.rows, second.rows, path.read_bytes(), out)
    (r1, r2, journal, out), want = got[tt], got[jt]
    assert r1 == want[0] and r2 == want[1] and journal == want[2]
    np.testing.assert_array_equal(out, want[3])
    assert (out >= 0).all()


def test_chat_against_loopback_server_equals_jax():
    """Both pools POST to one loopback /chat/completions: a 500 (retried),
    then a reply with JSON in its text."""
    seen = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            seen.append((self.path, self.headers["Authorization"], body["model"]))
            if len(seen) % 2:
                self.send_error(500)
                return
            text = f'Sure: {{"level_1": "{body["messages"][-1]["content"]}"}}'
            data = json.dumps({"choices": [{"message": {"content": text}}]}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/v1/"
        msgs = [{"role": "user", "content": "hi"}]
        out = [mod.LLMPool([mod.LLMEndpoint(url, api_key="k", model="m")], retry_delay=0)
               .chat(msgs) for mod in (tt, jt)]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert out[0] == out[1] == {"level_1": "hi"}
    assert seen == [("/v1/chat/completions", "Bearer k", "m")] * 4
