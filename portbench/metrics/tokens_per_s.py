"""tokens_per_s: tokens of the whole units completed in the window over
the window's time (host clock, ended by a synchronize). Training: every
token of the steps; prefill: the prompts' tokens, padding excluded."""


def read(run):
    if run.work.unit != "tokens":
        return None
    return run.window.units / run.window.seconds
