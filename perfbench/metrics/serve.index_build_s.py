"""Host seconds of the RetrievalEngine constructor: the corpus sweep
through rq_assign, the audit's host pass, the prefix index and tries,
ending in a synchronize."""


def read(run):
    xs = run.spans.get("serve.engine_build")
    return xs[0] if run.family == "serve" and xs else None
