"""The PyTorch package's front ends on the CPU: the command line
(``python -m stable_diffusion_videos_tpu_torch``), the gradio app's
callbacks (with a stub ``gradio`` module: neither this host nor the card's
has gradio), the hub upload (``huggingface_hub`` replaced) and the serve
command as a process.  Also: the front ends, run end to end, import
neither jax nor the JAX package.
"""

import base64
import io
import json
import os
import socket
import subprocess
import sys
import time
import types
from http.client import HTTPConnection
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from stable_diffusion_videos_tpu_torch.__main__ import build_parser, main

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def env() -> dict:
    return {**{k: v for k, v in os.environ.items() if k != "EAGER_IMPORT"},
            "OMP_NUM_THREADS": "2"}


def test_walk_parsing():
    args = build_parser().parse_args([
        "walk", "--prompts", "a", "b", "--seeds", "1", "2",
        "--interpolation-steps", "3", "--steps", "4", "--scheduler", "dpm",
        "--lora", "x.safetensors:0.5", "--tome", "0.5", "1",
        "--guidance-interval", "0.1", "0.9"])
    assert args.fn.__name__ == "cmd_walk"
    assert args.device == "cuda"  # the card unless asked otherwise
    assert (args.prompts, args.seeds, args.interpolation_steps) == (
        ["a", "b"], [1, 2], [3])
    assert (args.steps, args.scheduler, args.lora, args.tome) == (
        4, "dpm", ["x.safetensors:0.5"], [0.5, 1.0])
    assert args.guidance_interval == [0.1, 0.9] and not args.tiled


def test_images_and_serve_parsing():
    im = build_parser().parse_args([
        "images", "--prompt", "p", "--num-batches", "2", "--seeds", "1", "2",
        "--device", "cpu", "--push-to-hub", "--repo-id", "me/x"])
    assert im.fn.__name__ == "cmd_images"
    assert (im.prompt, im.num_batches, im.seeds, im.device) == (
        "p", 2, [1, 2], "cpu")
    assert im.push_to_hub and im.repo_id == "me/x"
    srv = build_parser().parse_args(["serve", "--port", "0",
                                     "--checkpoint", "dir", "--tiled"])
    assert srv.fn.__name__ == "cmd_serve"
    assert (srv.host, srv.port, srv.output_root) == ("127.0.0.1", 0,
                                                    "./dreams")
    assert srv.checkpoint == "dir" and srv.tiled
    for cmd in ("convert", "compare", "parity-gate", "validate", "bench"):
        with pytest.raises(SystemExit):
            build_parser().parse_args([cmd])


def test_tiny_walk_on_the_cpu(tmp_path, capsys):
    main(["walk", "--device", "cpu", "--prompts", "a", "b", "--seeds", "1",
          "2", "--interpolation-steps", "2", "--steps", "2",
          "--batch-size", "2", "--fps", "2", "--output-dir", str(tmp_path),
          "--name", "cli"])
    video = capsys.readouterr().out.strip().splitlines()[-1]
    assert Path(video).exists() and Path(video).stat().st_size > 0
    assert len(list((tmp_path / "cli").glob("**/frame*.png"))) == 2
    cfg = json.loads((tmp_path / "cli" / "prompt_config.json").read_text())
    assert cfg["num_inference_steps"] == 2 and cfg["tiled"] is False


def test_cuda_without_a_card_is_an_error(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(["walk", "--prompts", "a", "b", "--seeds", "1", "2",
              "--output-dir", str(tmp_path)])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_argument_errors(capsys):
    for argv, msg in ((["--ip-image", "x.png"], "--ip-adapter"),
                      (["--freeu", "1", "2"], "0 or 4"),
                      (["--control-image", "x.png"], "--controlnet"),
                      (["--lora", "x.safetensors"], "--checkpoint")):
        with pytest.raises(SystemExit) as e:
            main(["walk", "--device", "cpu", "--prompts", "a", "b",
                  "--seeds", "1", "2", *argv])
        assert e.value.code == 2 and msg in capsys.readouterr().err


def mock_hub(monkeypatch) -> list:
    import huggingface_hub
    commits = []
    monkeypatch.setattr(huggingface_hub, "create_repo",
                        lambda repo_id, **kw: f"https://hub/{repo_id}")
    monkeypatch.setattr(
        huggingface_hub, "CommitOperationAdd",
        lambda path_in_repo, path_or_fileobj: (path_in_repo, path_or_fileobj))
    monkeypatch.setattr(
        huggingface_hub, "create_commit",
        lambda repo_id, operations, commit_message, **kw: commits.append(
            (repo_id, commit_message, operations)))
    return commits


def test_upload_folder_chunked_mocked(monkeypatch, tmp_path):
    from stable_diffusion_videos_tpu_torch.hub import (get_groups_of_n,
                                                       upload_folder_chunked)
    assert list(get_groups_of_n(3, iter(range(8)))) == [[0, 1, 2],
                                                        [3, 4, 5], [6, 7]]
    with pytest.raises(ValueError):
        list(get_groups_of_n(0, iter(range(3))))
    d = tmp_path / "frames"
    (d / "clip0").mkdir(parents=True)
    for i in range(5):
        (d / "clip0" / f"frame{i:06d}.png").write_bytes(b"x" * 10)
    commits = mock_hub(monkeypatch)
    upload_folder_chunked("user/frames", d, n=2)
    assert [len(ops) for _, _, ops in commits] == [2, 2, 1]
    assert commits[0][2][0][0].startswith("clip0/frame")
    with pytest.raises(ValueError, match="does not exist"):
        upload_folder_chunked("user/frames", tmp_path / "nope")


def test_images_command_pushes_to_the_hub(monkeypatch, tmp_path, capsys):
    commits = mock_hub(monkeypatch)
    main(["images", "--device", "cpu", "--prompt", "a fox", "--batch-size",
          "2", "--seeds", "3", "4", "--steps", "2", "--output-dir",
          str(tmp_path), "--name", "im", "--push-to-hub", "--repo-id",
          "me/imgs"])
    paths = capsys.readouterr().out.split()
    assert [Path(p).name for p in paths] == ["3.jpg", "4.jpg"]
    assert [c[0] for c in commits] == ["me/imgs"]
    assert sorted(name for name, _ in commits[0][2]) == [
        "im/3.jpg", "im/4.jpg", "im/prompt_config.json"]


# ---------------------------------------------------------------------------
# the gradio app, on a stub gradio
# ---------------------------------------------------------------------------

def stub_gradio() -> types.ModuleType:
    gr = types.ModuleType("gradio")

    class Component:
        def __init__(self, *args, **kwargs):
            self.args, self.kwargs = args, kwargs

    for name in ("Textbox", "Dropdown", "Slider", "Checkbox", "Gallery",
                 "Video"):
        setattr(gr, name, type(name, (Component,), {}))

    class Interface(Component):
        def __init__(self, fn, inputs, outputs):
            super().__init__(fn, inputs, outputs)
            self.fn, self.inputs = fn, inputs

    class TabbedInterface(Component):
        def launch(self, **kwargs):
            self.launched = kwargs

    class Error(Exception):
        pass

    gr.Interface, gr.TabbedInterface, gr.Error = (Interface, TabbedInterface,
                                                  Error)
    return gr


def test_app_callbacks_with_a_stub_gradio(monkeypatch, tmp_path):
    from stable_diffusion_videos_tpu_torch.app import Interface
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    gr = stub_gradio()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    pipe = StableDiffusionWalkPipeline.tiny(CPU, safety=False)
    app = Interface(pipe)
    assert app.interface_images.fn == app.fn_images
    assert len(app.interface_videos.inputs) == 11
    out = app.fn_images("a fox", " ", "7", "ddim", 2, 1, 10, 7.5, False,
                        str(tmp_path / "images"))
    assert [label for _, label in out] == ["7", "8"]
    assert all(Path(p).exists() for p, _ in out)
    assert pipe.engine.scheduler_name == "ddim"
    with pytest.raises(gr.Error, match="whole number"):
        app.fn_images("a", "", "seven", "ddim", 1, 1, 10, 7.5, False,
                      str(tmp_path / "images"))
    video = app.fn_videos("a fox\n\nblue sky", "1\n2", "", "pndm", 3, 3, 2,
                          10, 7.5, False, str(tmp_path / "dreams"))
    assert Path(video).exists() and pipe.engine.scheduler_name == "pndm"
    with pytest.raises(gr.Error, match="whole numbers"):
        app.fn_videos("a\nb", "1\nx", "", "pndm", 3, 3, 1, 10, 7.5, False,
                      str(tmp_path / "dreams"))
    app.launch(share=False)
    assert app.interface.launched == {"share": False}
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio is required"):
        Interface(pipe)


# ---------------------------------------------------------------------------
# the serve command as a process, and no JAX anywhere
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def request(port, method, path, body=None, timeout=120):
    conn = HTTPConnection("127.0.0.1", port, timeout=timeout)
    data = json.dumps(body).encode() if body is not None else None
    conn.request(method, path, body=data,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def test_serve_command_answers(tmp_path):
    """``python -m stable_diffusion_videos_tpu_torch serve --device cpu``
    answers /health and /generate; its image is the tiny pipeline's
    ``generate`` of the same request."""
    from stable_diffusion_videos_tpu_torch.pipeline import \
        StableDiffusionWalkPipeline
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "stable_diffusion_videos_tpu_torch", "serve",
         "--device", "cpu", "--port", str(port), "--output-root",
         str(tmp_path)], cwd=ROOT, env=env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while True:
            try:
                status, health = request(port, "GET", "/health", timeout=5)
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.time() < deadline, "the server did not start"
                time.sleep(0.2)
        assert status == 200 and health["backend"] == "cpu"
        status, body = request(port, "POST", "/generate", {
            "prompt": "a fox", "seed": 3, "num_inference_steps": 2})
        assert status == 200
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    got = np.asarray(Image.open(io.BytesIO(base64.b64decode(
        body["images"][0]))))
    want = StableDiffusionWalkPipeline.tiny(CPU, safety=False).generate(
        "a fox", seed=3, num_inference_steps=2)[0]
    np.testing.assert_array_equal(got, np.asarray(want))


def test_front_ends_never_import_jax(tmp_path):
    """The command line's walk and images, the server and its batcher
    serving /generate, /warmup and a /walk job, ``from_pretrained`` of a
    diffusers directory and of a single file, the hub module and the app
    module, all in one process: no jax, no JAX package in ``sys.modules``."""
    from test_ldm import _write_tokenizer
    from test_torch_from_pretrained import single_file, write_diffusers_dir
    from test_torch_sdxl import jax_models

    from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
    ckpt = write_diffusers_dir(tmp_path / "ckpt",
                               jax_models(SDModels.tiny()), {})
    single, _, over = single_file(tmp_path, "sd1")
    tok = _write_tokenizer(tmp_path)
    code = f"""
import json, sys, torch
from http.client import HTTPConnection
torch.set_num_threads(2)
from stable_diffusion_videos_tpu_torch import app, hub
from stable_diffusion_videos_tpu_torch.__main__ import main
from stable_diffusion_videos_tpu_torch.models.ldm import load_ldm_checkpoint
from stable_diffusion_videos_tpu_torch.pipeline import \\
    StableDiffusionWalkPipeline as P
from stable_diffusion_videos_tpu_torch.runtime.server import Server
out = {str(tmp_path)!r}
main(['walk', '--device', 'cpu', '--checkpoint', {str(ckpt)!r},
      '--prompts', 'a', 'b', '--seeds', '1', '2', '--interpolation-steps',
      '2', '--steps', '2', '--batch-size', '2', '--output-dir', out,
      '--name', 'w'])
main(['images', '--device', 'cpu', '--prompt', 'a', '--batch-size', '1',
      '--steps', '2', '--output-dir', out, '--name', 'i'])
m = load_ldm_checkpoint({str(single)!r}, tokenizer_dir={str(tok)!r},
                        dtype=torch.float32, **{over!r})
server = Server(P.from_pretrained({str(ckpt)!r}, device='cpu',
                                  dtype=torch.float32), output_root=out)
host, port = server.start(port=0)
def req(method, path, body=None):
    c = HTTPConnection(host, port, timeout=120)
    c.request(method, path, body=json.dumps(body).encode() if body else None)
    r = c.getresponse()
    return r.status, json.loads(r.read())
assert req('POST', '/warmup', {{'num_inference_steps': 2}})[0] == 200
assert req('POST', '/generate', {{'prompt': 'a', 'count': 2,
                                  'num_inference_steps': 2}})[0] == 200
s, job = req('POST', '/walk', {{'prompts': ['a', 'b'], 'seeds': [1, 2],
                                'num_interpolation_steps': 2,
                                'num_inference_steps': 2,
                                'make_video': False, 'name': 'j'}})
import time
while req('GET', '/jobs/' + job['job_id'])[1]['status'] not in ('done',
                                                                 'error'):
    time.sleep(0.1)
assert req('GET', '/jobs/' + job['job_id'])[1]['status'] == 'done'
server.shutdown()
bad = sorted(m for m in sys.modules if m.split('.')[0] in
             ('jax', 'jaxlib', 'flax', 'stable_diffusion_videos_tpu'))
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=ROOT, env=env())
    assert len(list(tmp_path.glob("w/**/frame*.png"))) == 2
    assert len(list(tmp_path.glob("i/*.jpg"))) == 1
    assert len(list(tmp_path.glob("j/**/frame*.png"))) == 2
