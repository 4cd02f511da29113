"""Process start to the first timed operation (host clock): imports, the
kernel library's load (its build in a checkout's first run), the inputs
made on the device, and the warm-up of every shape the window uses."""


def read(run):
    return run.setup_s
