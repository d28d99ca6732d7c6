"""The share of the window's queries the screen's rescue gate sent to its
stage 3 (the program's counter ``ScreenedAlignmentEngine.escalated``)."""


def read(r):
    if r.escalated is None or not r.attempted:
        return None
    return 100.0 * r.escalated / r.attempted
