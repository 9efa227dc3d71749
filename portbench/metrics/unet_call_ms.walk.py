"""Models: ms of one UNet call at the cell's rows (CFG doubled), CUDA
events over 5 calls after a warm one, taken after the window."""


def read(obs):
    return obs.get("unet_call_ms")
