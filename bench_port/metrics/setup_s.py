"""Set-up: process start to the window's start (imports, the CUDA context,
the model and its weights on the device, the scenes, the warm-up of every
shape the traffic uses; on a checkout's first run also the kernels'
build)."""

UNIT, SOURCE, BETTER = 's', 'host_clock', 'lower'


def read(obs):
    return obs['setup_s']
