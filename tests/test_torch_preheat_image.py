"""Image preheat on the port: ``scheduler/job.resolve_image_layers``
through the port's source client against the reference's on a registry
stand-in (a single manifest; a multi-arch index, with its platform and
with one it lacks), and an image preheat job end to end on the CPU — the
port's job worker resolves the manifest and its seed-peer client has the
port's seed daemon fetch every layer from the registry."""

from __future__ import annotations

import hashlib
import http.server
import json
import random
import threading
import time

import pytest

from dragonfly2_torch.client import dfget
from dragonfly2_torch.client.daemon import Daemon, DaemonConfig
from dragonfly2_torch.client.piece_manager import TRAFFIC_BACK_TO_SOURCE, TRAFFIC_REMOTE_PEER
from dragonfly2_torch.rpc.glue import SCHEDULER_SERVICE, serve
from dragonfly2_torch.scheduler import job as t_job
from dragonfly2_torch.scheduler import resource as res
from dragonfly2_torch.scheduler.evaluator import BaseEvaluator
from dragonfly2_torch.scheduler.resource.seed_peer import SeedPeerClient
from dragonfly2_torch.scheduler.scheduling import Scheduling, SchedulingConfig
from dragonfly2_torch.scheduler.service import SchedulerService
from dragonfly2_torch.scheduler.storage import Storage

from dragonfly2_tpu.scheduler import job as j_job
from dragonfly2_torch.utils import profiling as t_profiling
from dragonfly2_tpu.utils import profiling as j_profiling

PIECE = 32 * 1024
_rng = random.Random(0)
BLOBS = {f"sha256:{hashlib.sha256(b).hexdigest()}": b
         for b in (_rng.randbytes(3 * PIECE), _rng.randbytes(PIECE + 5), _rng.randbytes(7))}
DIGESTS = list(BLOBS)
MANIFEST = {
    "schemaVersion": 2,
    "mediaType": "application/vnd.oci.image.manifest.v1+json",
    "config": {"digest": "sha256:" + "c" * 64, "size": 2},
    "layers": [{"digest": d, "size": len(BLOBS[d])} for d in DIGESTS],
}
INDEX = {
    "schemaVersion": 2,
    "mediaType": "application/vnd.oci.image.index.v1+json",
    "manifests": [
        {"digest": "sha256:arm-manifest", "platform": {"os": "linux", "architecture": "arm64"}},
        {"digest": "sha256:amd-manifest", "platform": {"os": "linux", "architecture": "amd64"}},
    ],
}


@pytest.fixture(autouse=True, scope="module")
def samplers_stop_with_the_module():
    # each package's daemons and servers start its process-wide stack sampler
    # and leave it running, as a server process would; stop both once the
    # module is done so their sweeps do not tax the files run after it in
    # this process
    yield
    t_profiling.stop()
    j_profiling.stop()


@pytest.fixture
def registry():
    """Manifests, an index and blobs at the registry API's paths; the
    Accept header of every manifest request is kept."""
    accepts = []

    class Registry(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _body(self):
            if self.path.endswith("/manifests/latest") or self.path.endswith("/manifests/sha256:amd-manifest"):
                accepts.append(self.headers.get("Accept", ""))
                return json.dumps(MANIFEST).encode()
            if self.path.endswith("/manifests/multi"):
                accepts.append(self.headers.get("Accept", ""))
                return json.dumps(INDEX).encode()
            digest = self.path.rsplit("/blobs/", 1)[-1]
            return BLOBS.get(digest) if "/blobs/" in self.path else None

        def do_HEAD(self):
            body = self._body()
            if body is None:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Accept-Ranges", "bytes")
            self.end_headers()

        def do_GET(self):
            body = self._body()
            if body is None:
                self.send_error(404)
                return
            rng = self.headers.get("Range")
            status = 200
            if rng:
                lo, _, hi = rng.removeprefix("bytes=").partition("-")
                body = body[int(lo) : (int(hi) + 1 if hi else None)]
                status = 206
            self.send_response(status)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Registry)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_port}", accepts
    httpd.shutdown()
    httpd.server_close()


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:
        return ("raise", type(e).__name__, str(e))


@pytest.mark.parametrize("ref,platform", [
    ("latest", "linux/amd64"),
    ("multi", "linux/amd64"),
    ("multi", "linux/s390x"),
    ("missing", "linux/amd64"),
])
def test_resolve_image_layers_matches_the_reference(registry, ref, platform):
    base, accepts = registry
    url = f"{base}/v2/lib/app/manifests/{ref}"
    got = _outcome(t_job.resolve_image_layers, url, platform=platform, timeout=5.0)
    n = len(accepts)
    assert got == _outcome(j_job.resolve_image_layers, url, platform=platform, timeout=5.0)
    if ref != "missing" and platform == "linux/amd64":
        assert got == ("ok", [f"{base}/v2/lib/app/blobs/{d}" for d in DIGESTS])
        # both asked for manifests and indexes alike
        assert accepts[:n] == accepts[n:] and "image.index" in accepts[0]
    else:
        assert got[0] == "raise"


class _SeedSpy:
    def __init__(self):
        self.triggered = []

    def seed_hosts(self):
        return ["seed"]

    def trigger(self, task_id, url, **kw):
        self.triggered.append((task_id, url, kw))
        return True


def test_image_preheat_job_matches_the_reference(registry):
    base, _ = registry
    args = {"type": "image", "url": f"{base}/v2/lib/app/manifests/multi", "tag": "t"}
    spies = [_SeedSpy(), _SeedSpy()]
    got = [
        mod.JobWorker(None, None, seed_client=spy).execute_now("preheat", args)
        for mod, spy in zip((t_job, j_job), spies)
    ]
    assert got[0] == got[1]
    assert got[0][0] == "succeeded" and got[0][1]["layers"] == 3
    assert spies[0].triggered == spies[1].triggered


def test_image_preheat_seeds_every_layer(tmp_path, registry):
    """A leased-style image preheat job on the port's worker: the seed
    daemon fetches every layer from the registry, and a peer's later pull
    of a layer comes from the seed, not the registry."""
    base, _ = registry
    resource = res.Resource()
    storage = Storage(tmp_path / "sched", buffer_size=1)
    service = SchedulerService(
        resource,
        Scheduling(BaseEvaluator(), SchedulingConfig(retry_interval=0.05, retry_back_to_source_limit=3)),
        storage=storage,
    )
    server, port = serve({SCHEDULER_SERVICE: service})
    daemons = {}
    try:
        for name, host_type in (("seed", "super"), ("peer", "normal")):
            daemons[name] = Daemon(DaemonConfig(
                data_dir=str(tmp_path / name), scheduler_address=f"127.0.0.1:{port}",
                hostname=f"host-{name}", ip="127.0.0.1", host_type=host_type,
                piece_length=PIECE, schedule_timeout=10.0, announce_interval=60.0,
            ))
            daemons[name].start()
        seed_client = SeedPeerClient(resource.host_manager)
        assert len(seed_client.seed_hosts()) == 1
        worker = t_job.JobWorker(None, resource, seed_client=seed_client, device="cpu")
        state, result = worker.execute_now(
            "preheat", {"type": "image", "url": f"{base}/v2/lib/app/manifests/latest"}
        )
        assert state == "succeeded" and result["layers"] == 3 and result["count"] == 3
        seed = daemons["seed"]
        deadline = time.time() + 30
        for task_id in result["triggered"]:
            while time.time() < deadline and seed.storage.find_completed_task(task_id) is None:
                time.sleep(0.05)
        for d in DIGESTS:
            url = f"{base}/v2/lib/app/blobs/{d}"
            ts = seed.storage.find_completed_task(seed.task_manager.task_id_for(url, None))
            assert ts is not None and ts.read_all() == BLOBS[d]
            assert {p.traffic_type for p in ts.meta.pieces.values()} == {TRAFFIC_BACK_TO_SOURCE}
        # the peer's pull of the largest layer rides P2P from the seed
        url = f"{base}/v2/lib/app/blobs/{DIGESTS[0]}"
        out = tmp_path / "layer.bin"
        dfget.download(f"127.0.0.1:{daemons['peer'].port}", url, str(out))
        assert out.read_bytes() == BLOBS[DIGESTS[0]]
        peer = daemons["peer"]
        ts = peer.storage.find_completed_task(peer.task_manager.task_id_for(url, None))
        assert {p.traffic_type for p in ts.meta.pieces.values()} == {TRAFFIC_REMOTE_PEER}
    finally:
        for d in daemons.values():
            d.stop()
        server.stop(0)
