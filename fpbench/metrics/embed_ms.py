"""Mean host time of a batch's call into ``Embedder.embed_songs`` (it ends
in a copy to the host, so the card's work is in it)."""


def read(r):
    s = r.spans.get("embed")
    return 1e3 * sum(s) / len(s) if s else None
