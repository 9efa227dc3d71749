"""Walk: the pipeline's ``StageTimer`` seconds of ``denoise`` (each batch
up to the event after its device work) over the window's wall seconds,
in percent."""


def read(obs):
    w = obs["window"]
    stages = w.get("stages")
    if not stages or "denoise" not in stages:
        return None
    return 100.0 * stages["denoise"] / w["seconds"]
