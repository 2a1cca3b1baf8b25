"""The window's seconds over the clouds served in it (ms/query)."""


def read(run):
    if run.kind != "serve":
        return None
    return 1e3 * run.window.seconds / run.window.clouds
