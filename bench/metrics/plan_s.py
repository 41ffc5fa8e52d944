"""``plan_s``: seconds inside ``Dispatcher.plan`` (classify, model every
candidate, choose), timed by the benchmark around the call."""


def read(rec):
    """The plan call's time, or None if the program never planned."""
    return rec.plan_s
