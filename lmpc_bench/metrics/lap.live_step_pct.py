"""Share of executed scenario-steps that were live (the scenario had not
yet crossed the line), over the window's episodes: the lap runner's
frozen-scenario waste."""


def read(rec):
    ex = rec["counters"]["executed"]
    return 100.0 * rec["counters"]["live"] / ex if ex else None
