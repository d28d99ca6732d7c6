"""Mean host time of a batch's call into ``Database.query_top1_batch``
(its answers are host values, so the card's work is in it)."""


def read(r):
    s = r.spans.get("search")
    return 1e3 * sum(s) / len(s) if s else None
