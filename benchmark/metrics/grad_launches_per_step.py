"""Device operations in the traced window over the train steps in it: the
forward render's, the tape's backward and the update's launches."""


def read(run):
    if not run.trace_steps or not run.trace.device:
        return None
    return len(run.trace.device) / run.trace_steps
