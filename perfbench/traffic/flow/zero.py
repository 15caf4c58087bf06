"""Flow ``zero``: no flows are given; the program runs its zero-flow
path."""


def make(mix: dict, clean):
    return None
