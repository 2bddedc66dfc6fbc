"""The port's remote checkpoints (utils/paths.py) over a loopback HTTP
server on 127.0.0.1, as tests/test_remote_checkpoint.py serves the JAX
package's: an archive of a checkpoint directory is fetched once into
checkpoints/ and then read from the cache; a corrupt archive is dropped
so that the next attempt fetches it anew; a URL that is not an archive is
refused before any request; local paths pass through; and the train CLI
evaluates a checkpoint given by URL. Nothing leaves the machine."""

import http.server
import math
import os
import socketserver
import tarfile
import threading
import urllib.request
import zipfile

import pytest

from omniisaacgymenvs_torch.scripts import train
from omniisaacgymenvs_torch.utils.paths import retrieve_checkpoint_path


@pytest.fixture
def server(tmp_path, monkeypatch):
    """(served directory, base URL, the list of requested paths). Proxy
    settings are cleared, so that a request for 127.0.0.1 goes nowhere
    else."""
    for var in ("http_proxy", "https_proxy", "all_proxy", "HTTP_PROXY",
                "HTTPS_PROXY", "ALL_PROXY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("no_proxy", "*")
    monkeypatch.setattr(urllib.request, "_opener", None)
    root = tmp_path / "www"
    root.mkdir()
    requests = []

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(root), **kw)

        def do_GET(self):
            requests.append(self.path)
            return super().do_GET()

        def log_message(self, *a):
            pass

    with socketserver.TCPServer(("127.0.0.1", 0), Handler) as httpd:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            yield root, f"http://127.0.0.1:{httpd.server_address[1]}", requests
        finally:
            httpd.shutdown()
            t.join(timeout=10)
    assert not t.is_alive()


def _checkpoint_dir(path):
    os.makedirs(path)
    for name in ("model.pt", "env.pt"):
        with open(os.path.join(path, name), "wb") as f:
            f.write(os.urandom(64))
    return path


@pytest.mark.parametrize("suffix", [".tar.gz", ".zip"])
def test_archive_is_fetched_once_then_cached(suffix, server, tmp_path, monkeypatch):
    root, url, requests = server
    monkeypatch.chdir(tmp_path)
    src = _checkpoint_dir(str(tmp_path / "src" / "ckpt"))
    if suffix == ".zip":
        with zipfile.ZipFile(root / f"ckpt{suffix}", "w") as z:
            for name in os.listdir(src):
                z.write(os.path.join(src, name), f"ckpt/{name}")
    else:
        with tarfile.open(root / f"ckpt{suffix}", "w:gz") as t:
            t.add(src, arcname="ckpt")
    first = retrieve_checkpoint_path(f"{url}/ckpt{suffix}")
    assert first == os.path.join("checkpoints", "ckpt", "ckpt")
    for name in ("model.pt", "env.pt"):
        assert open(os.path.join(first, name), "rb").read() == \
            open(os.path.join(src, name), "rb").read()
    again = retrieve_checkpoint_path(f"{url}/ckpt{suffix}?v=1")
    assert again == first and requests == [f"/ckpt{suffix}"]
    assert not [e for e in os.listdir("checkpoints") if e.endswith(".part")]


def test_corrupt_archive_is_dropped_and_fetched_again(server, tmp_path, monkeypatch):
    root, url, requests = server
    monkeypatch.chdir(tmp_path)
    (root / "bad.tar.gz").write_bytes(b"not a gzip stream" * 8)
    with pytest.raises((tarfile.TarError, EOFError, OSError)):
        retrieve_checkpoint_path(f"{url}/bad.tar.gz")
    assert sorted(os.listdir("checkpoints")) == []
    # the server now holds a good archive under the same name
    src = _checkpoint_dir(str(tmp_path / "src" / "bad"))
    with tarfile.open(root / "bad.tar.gz", "w:gz") as t:
        t.add(src, arcname="bad")
    path = retrieve_checkpoint_path(f"{url}/bad.tar.gz")
    assert sorted(os.listdir(path)) == ["env.pt", "model.pt"]
    assert requests == ["/bad.tar.gz", "/bad.tar.gz"]


def test_url_of_no_archive_is_refused_before_any_request(server, tmp_path,
                                                         monkeypatch):
    _, url, requests = server
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="archive"):
        retrieve_checkpoint_path(f"{url}/ckpt.pth")
    assert requests == [] and not os.path.exists("checkpoints")


@pytest.mark.parametrize("path", ["runs/Ant/nn/best", "/abs/nn/last", "nn"])
def test_local_paths_pass_through(path):
    assert retrieve_checkpoint_path(path) == path


def test_train_cli_evaluates_a_remote_checkpoint(server, tmp_path, monkeypatch, capsys):
    root, url, requests = server
    monkeypatch.chdir(tmp_path)
    cli = ["task=Cartpole", "num_envs=16", "device=cpu", "seed=7"]
    train.main(cli + ["max_iterations=2", "experiment=src",
                      "train.params.config.save_frequency=2"])
    with tarfile.open(root / "cartpole.tgz", "w:gz") as t:
        t.add(tmp_path / "runs" / "src" / "nn" / "last", arcname="cartpole")
    capsys.readouterr()
    mean_ret, _ = train.main(cli + ["test=True", "max_iterations=16",
                                    f"checkpoint={url}/cartpole.tgz"])
    out = capsys.readouterr().out
    assert f"loaded checkpoint {url}/cartpole.tgz (epoch 2)" in out
    assert "eval: mean episode reward" in out and math.isfinite(mean_ret)
    assert requests == ["/cartpole.tgz"]
    assert os.path.isdir(tmp_path / "checkpoints" / "cartpole" / "cartpole")
