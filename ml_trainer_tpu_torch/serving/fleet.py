"""A serving fleet of worker processes (the JAX package's
``serving/fleet.py``).

Every replica is its own process, a ``Server`` behind its HTTP front
end, and the router in the parent process reaches it only over sockets:

* :class:`RemoteServer` stands in for an in-process ``Server`` where the
  router drives one.  Streams ride ``POST /v1/stream`` (NDJSON); a KV
  migration ships the serialized ``KVSlotExport`` over ``POST
  /v1/adopt``, CRC-verified by the receiving process, whose verdict
  (``corrupt``, ``weights_mismatch``, ``no_memory``, ``draining``,
  ``unhealthy``) comes back as the exception the in-process path
  raises.  ``kill_process`` is a real ``SIGKILL``.
* :class:`Fleet` spawns each replica as ``python -m
  ml_trainer_tpu_torch.serving.fleet --worker ...`` on a port of its
  own, waits for ``/v1/spec``, and hands ``make_router`` the
  ``{name: RemoteServer}`` map.

A worker serves on the card unless given ``--device cpu``; with no card
it exits non-zero with the device error and never serves on the CPU.
Its weights are the port's seeded init (``init_model(--model,
seed=--seed)``, the same in every process) or ``--ckpt``, a ``.pth``
the port wrote (``save_model``/``export_torch``; ``load_model`` reads
it).  The JAX package's workers draw theirs from ``jax.random``, which
the port does not reproduce.  Workers load the kernels the checkout
built (``ops/kernels/_build``: a build directory keyed by the sources'
hash), so a fleet started after one build compiles nothing.
"""

from __future__ import annotations

import base64
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence

from ml_trainer_tpu_torch.serving.api import _KV_MIGRATE as _MIGRATE
from ml_trainer_tpu_torch.serving.api import _M_LINE
from ml_trainer_tpu_torch.serving.overload import OverloadShed
from ml_trainer_tpu_torch.serving.scheduler import (
    AdmissionError,
    EngineUnhealthy,
    Request,
)
from ml_trainer_tpu_torch.serving.transfer import (
    MigrationCorrupt,
    WeightsMismatch,
    request_wire_meta,
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _RemoteSlo:
    """``server.slo`` over ``GET /slo``; a dead process reads as
    perfect attainment instead of stalling the router's publish."""

    def __init__(self, remote: "RemoteServer"):
        self._remote = remote

    def snapshot(self) -> dict:
        try:
            return self._remote._get("/slo")
        except Exception:  # noqa: BLE001 - a dead worker
            return {"attainment": {"ttft": 1.0, "tpot": 1.0}}

    def forget(self, req) -> None:  # the worker keeps its own books
        pass


class RemoteServer:
    """The surface the router drives on a ``Server``, over HTTP to one
    replica process.  The constructor reads ``GET /v1/spec`` and mirrors
    the engine's geometry into ``self.engine``/``self.scheduler``.
    ``submit_request``/``adopt_payload`` open NDJSON streams and a daemon
    thread pumps each into the shadow request; a severed socket (a
    killed replica) finishes the shadow with a retryable ``unhealthy``
    error, which the router redistributes."""

    def __init__(self, url: str, proc: Optional[subprocess.Popen] = None,
                 name: str = "", stream_timeout: float = 600.0,
                 log_path: Optional[str] = None):
        self.url = url.rstrip("/")
        self.proc = proc
        self.name = name or self.url
        self.transport = "http"
        self.log_path = log_path
        self._stream_timeout = float(stream_timeout)
        spec = self.spec(timeout=10.0)
        self.pid = spec.get("pid")
        self.engine = types.SimpleNamespace(
            max_len=int(spec["max_len"]),
            vocab_size=int(spec["vocab_size"]),
            spec_k=int(spec["spec_k"]),
            kv_page_size=int(spec["kv_page_size"]),
            paged=bool(spec["paged"]),
            max_batch=int(spec["max_batch"]),
            prefill_chunk=int(spec.get("prefill_chunk", 0)),
            weights_fp=spec.get("weights_fp"))
        self.scheduler = types.SimpleNamespace(
            max_queue=int(spec["max_queue"]))
        self._role = spec.get("role", "both")
        self._replica_index = 0
        self.slo = _RemoteSlo(self)

    # -- plumbing ---------------------------------------------------------

    def _get(self, path: str, timeout: float = 5.0) -> dict:
        with urllib.request.urlopen(f"{self.url}{path}",
                                    timeout=timeout) as resp:
            return json.loads(resp.read())

    def _post(self, path: str, body: dict, timeout: float = 10.0) -> dict:
        req = urllib.request.Request(
            f"{self.url}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())

    def _open_stream(self, path: str, data: bytes, headers: dict):
        """POST and return the live NDJSON response."""
        req = urllib.request.Request(f"{self.url}{path}", data=data,
                                     headers=headers)
        return urllib.request.urlopen(req, timeout=self._stream_timeout)

    @staticmethod
    def _read_line(resp) -> Optional[dict]:
        line = resp.readline()
        if not line:
            return None
        return json.loads(line)

    def spec(self, timeout: float = 5.0) -> dict:
        """``GET /v1/spec``: the geometry, the process's kernel launches
        and the decode graph's captures."""
        return self._get("/v1/spec", timeout=timeout)

    # -- role and health --------------------------------------------------

    @property
    def role(self) -> str:
        return self._role

    @role.setter
    def role(self, value: str) -> None:
        self._role = value
        self._post("/admin/role", {"role": value})

    @property
    def replica_index(self) -> int:
        return self._replica_index

    @replica_index.setter
    def replica_index(self, value: int) -> None:
        self._replica_index = int(value)
        try:  # best effort: a reindex also runs after a kill
            self._post("/admin/replica_index", {"replica_index": value},
                       timeout=2.0)
        except Exception:  # noqa: BLE001
            pass

    def stderr_tail(self, max_bytes: int = 2048) -> Optional[str]:
        """The last ``max_bytes`` of the worker's log (stdout and stderr
        together): the post-mortem of a crash after readiness, which the
        autoscaler's replace-dead event attaches; None without one."""
        if not self.log_path:
            return None
        return _tail(self.log_path, int(max_bytes)) or None

    def health(self) -> dict:
        try:
            return self._get("/healthz", timeout=2.0)
        except urllib.error.HTTPError as e:  # a 503 still carries it
            try:
                return json.loads(e.read())
            except Exception:  # noqa: BLE001
                return {"ok": False, "healthy": False, "closed": True,
                        "reason": f"healthz HTTP {e.code}"}
        except Exception as e:  # noqa: BLE001
            return {"ok": False, "healthy": False, "closed": True,
                    "reason": f"replica process unreachable: {e}"}

    # -- the request path -------------------------------------------------

    @staticmethod
    def _raise_refusal(first: Optional[dict]) -> None:
        """A first line's refusal as the in-process exception."""
        if first is None:
            raise EngineUnhealthy(
                "serving engine unhealthy: replica closed the connection "
                "before the admission verdict")
        status = first.get("status")
        err = first.get("error", status)
        if status == "shed":
            raise OverloadShed(err, retry_after=first.get("retry_after"))
        if status == "draining":
            raise AdmissionError(err)
        if status == "unhealthy":
            raise EngineUnhealthy(err)
        if status == "closed":
            raise RuntimeError(err)
        if status == "corrupt":
            raise MigrationCorrupt(err)
        if status == "weights_mismatch":
            raise WeightsMismatch(err)
        if status == "no_memory":
            raise AdmissionError(f"adoption refused (no_memory): {err}")
        raise RuntimeError(f"unexpected fleet reply: {first}")

    def _pump_stream(self, shadow: Request, resp) -> None:
        """NDJSON lines into the shadow request.  A ``migrated`` end
        leaves the shadow open: its export already went into the stream
        and the router's pump adopts it elsewhere.  A transport failure
        finishes it with a retryable ``unhealthy`` error."""
        from ml_trainer_tpu_torch.serving import transfer

        head, tail = _M_LINE
        try:
            with resp:
                while True:
                    line = resp.readline()
                    if not line:
                        shadow.finish(
                            "error", "serving engine unhealthy: replica "
                            f"'{self.name}' connection lost mid-stream")
                        return
                    if line.startswith(head) and line.endswith(tail):
                        # The export's line, its base64 taken in place.
                        try:
                            export = transfer.from_bytes(base64.b64decode(
                                memoryview(line)[len(head):-len(tail)]))
                        except MigrationCorrupt as e:
                            shadow.finish(
                                "error", "serving engine unhealthy: "
                                "migration payload corrupt in transit from "
                                f"'{self.name}': {e}")
                            return
                        shadow._stream.put((_MIGRATE, export))
                        continue
                    obj = json.loads(line)
                    if "t" in obj:
                        shadow.push_token(int(obj["t"]))
                        continue
                    done = obj.get("done")
                    if done is not None:
                        if done.get("state") == "migrated":
                            return
                        if done.get("retry_after") is not None:
                            shadow.retry_after = done["retry_after"]
                        shadow.finish(done.get("state"), done.get("error"))
                        return
        except Exception as e:  # noqa: BLE001 - severed socket, bad line
            shadow.finish(
                "error", f"serving engine unhealthy: replica '{self.name}' "
                f"stream failed mid-flight: {e}")

    def _start_pump(self, shadow: Request, resp) -> None:
        threading.Thread(target=self._pump_stream, args=(shadow, resp),
                         daemon=True,
                         name=f"fleet-pump-{self.name}-{shadow.id}").start()

    def submit_request(self, shadow: Request) -> None:
        """``POST /v1/stream``: the request's identity out, the admission
        verdict back, then the tokens pumped into the shadow."""
        body = request_wire_meta(shadow)
        body["migrate"] = shadow.migration_sink is not None
        try:
            resp = self._open_stream(
                "/v1/stream", json.dumps(body).encode(),
                {"Content-Type": "application/json"})
            first = self._read_line(resp)
        except (OSError, ValueError) as e:
            raise EngineUnhealthy(
                f"serving engine unhealthy: replica '{self.name}' "
                f"unreachable: {e}")
        if first is None or first.get("status") != "accepted":
            with resp:
                self._raise_refusal(first)
        self._start_pump(shadow, resp)

    def adopt_payload(self, shadow: Request, payload: bytes) -> None:
        """``POST /v1/adopt``: the serialized export as the body, the
        request's identity in ``X-Request-Meta``; the receiving process
        verifies the CRC and answers the import's verdict.  On
        ``adopted`` the connection carries the continuation's tokens."""
        headers = {"Content-Type": "application/octet-stream",
                   "X-Request-Meta": json.dumps(request_wire_meta(shadow))}
        try:
            resp = self._open_stream("/v1/adopt", payload, headers)
            first = self._read_line(resp)
        except (OSError, ValueError) as e:
            raise EngineUnhealthy(
                f"serving engine unhealthy: replica '{self.name}' "
                f"unreachable for adoption: {e}")
        status = (first or {}).get("status")
        if status == "adopted":
            self._start_pump(shadow, resp)
            return
        if status in ("error", "expired", "cancelled"):
            # Terminals the in-process path reports by finishing the
            # request after the adoption was queued.
            with resp:
                shadow.finish("expired" if status == "expired" else "error",
                              first.get("error", status))
            return
        with resp:
            self._raise_refusal(first)

    def cancel(self, req: Request) -> None:
        req.cancel_requested = True
        try:
            self._post("/v1/cancel", {"id": int(req.id)}, timeout=5.0)
        except Exception:  # noqa: BLE001 - the replica may be failing it
            pass

    # -- the control surface ----------------------------------------------

    def evacuate(self, sink, timeout: float = 30.0) -> bool:
        """The exports ride each request's open stream as ``m`` lines,
        which the router's pumps adopt: ``sink`` is not used here."""
        del sink
        resp = self._post("/admin/evacuate", {"timeout": timeout},
                          timeout=timeout + 10.0)
        return bool(resp.get("ok"))

    def set_degradation(self, level: int, config) -> None:
        import dataclasses

        cfg = (dataclasses.asdict(config) if dataclasses.is_dataclass(config)
               else dict(config or {}))
        try:
            self._post("/admin/degradation",
                       {"level": int(level), "config": cfg}, timeout=5.0)
        except Exception:  # noqa: BLE001 - a dead replica is fine here
            pass

    def shed_queued(self, below_priority: int, retry_after: float,
                    cause: str = "overload") -> int:
        try:
            resp = self._post(
                "/admin/shed_queued",
                {"below_priority": int(below_priority),
                 "retry_after": float(retry_after), "cause": cause},
                timeout=5.0)
            return int(resp.get("shed", 0))
        except Exception:  # noqa: BLE001
            return 0

    def _mark_unhealthy(self, reason: str) -> None:
        try:  # the process may be gone already: that is the point
            self._post("/admin/fail", {"reason": reason}, timeout=2.0)
        except Exception:  # noqa: BLE001
            pass

    def kill_process(self) -> None:
        """A real ``SIGKILL``: nothing runs in the replica; recovery is
        the router's redistribution."""
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait(timeout=10.0)
        elif self.pid:
            try:
                os.kill(int(self.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    def close(self) -> None:
        """Ask the process to exit, then reap it."""
        try:
            self._post("/admin/shutdown", {}, timeout=5.0)
        except Exception:  # noqa: BLE001
            pass
        if self.proc is not None:
            try:
                self.proc.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10.0)


class Fleet:
    """Spawns and wires a fleet of replica processes::

        fleet = Fleet(["prefill", "decode"], ckpt="model.pth").start()
        router = fleet.make_router()   # owns the RemoteServers
        ...
        router.close(); fleet.stop()

    ``device`` is passed to every worker (None: the card); ``ckpt`` (a
    ``.pth`` the port wrote) replaces the seeded init; ``paged_kernel``
    runs the decode steps through K6.  Workers never inherit a chaos
    plan from the environment: faults fire in the router's process, or in
    a worker through its ``POST /admin/faults``."""

    def __init__(self, roles: Sequence[str], *,
                 model_name: str = "gpt2_tiny", max_len: int = 256,
                 max_batch: int = 4, max_queue: int = 64,
                 kv_page_size: int = 16, kv_pages: int = 0,
                 seed: int = 0, prefill_chunk: int = 0,
                 prefix_cache: bool = True, paged_kernel: bool = False,
                 ckpt: Optional[str] = None, device: Optional[str] = None,
                 host: str = "127.0.0.1",
                 log_dir: Optional[str] = None,
                 spawn_timeout: float = 300.0,
                 stream_timeout: float = 600.0):
        self.roles = list(roles)
        self.model_name = model_name
        self.max_len = int(max_len)
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.kv_page_size = int(kv_page_size)
        self.kv_pages = int(kv_pages)
        self.seed = int(seed)
        self.prefill_chunk = int(prefill_chunk)
        self.prefix_cache = bool(prefix_cache)
        self.paged_kernel = bool(paged_kernel)
        self.ckpt = ckpt
        self.device = device
        self.host = host
        self.spawn_timeout = float(spawn_timeout)
        self.stream_timeout = float(stream_timeout)
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="fleet-logs-")
        os.makedirs(self.log_dir, exist_ok=True)
        self.replicas: Dict[str, RemoteServer] = {}
        self._role_seq: Dict[str, int] = {}

    def _next_name(self, role: str) -> str:
        n = self._role_seq.get(role, 0)
        self._role_seq[role] = n + 1
        return f"{role}{n}"

    def _command(self, name: str, role: str, port: int,
                 ckpt: Optional[str] = None) -> List[str]:
        cmd = [sys.executable, "-m", "ml_trainer_tpu_torch.serving.fleet",
               "--worker", "--name", name, "--role", role,
               "--host", self.host, "--port", str(port),
               "--model", self.model_name, "--max-len", str(self.max_len),
               "--max-batch", str(self.max_batch),
               "--max-queue", str(self.max_queue),
               "--kv-page-size", str(self.kv_page_size),
               "--kv-pages", str(self.kv_pages), "--seed", str(self.seed),
               "--prefill-chunk", str(self.prefill_chunk)]
        ckpt = ckpt or self.ckpt
        if ckpt:
            cmd += ["--ckpt", ckpt]
        if self.device:
            cmd += ["--device", self.device]
        if self.paged_kernel:
            cmd.append("--paged-kernel")
        if not self.prefix_cache:
            cmd.append("--no-prefix-cache")
        return cmd

    def launch(self, name: str, role: str, ckpt: Optional[str] = None):
        """Start one replica process (its weights from ``ckpt`` when
        given, else the fleet's); returns ``(proc, url, log_path)``
        without waiting (``wait_ready`` waits)."""
        from ml_trainer_tpu_torch.resilience.faults import ENV_VAR

        port = _free_port()
        log_path = os.path.join(self.log_dir, f"{name}.log")
        env = dict(os.environ)
        env.pop(ENV_VAR, None)  # faults fire in the router's process
        # The package from this checkout, wherever the caller runs.
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        with open(log_path, "w") as log_file:
            proc = subprocess.Popen(self._command(name, role, port, ckpt),
                                    env=env,
                                    stdout=log_file,
                                    stderr=subprocess.STDOUT)
        return proc, f"http://{self.host}:{port}", log_path

    def wait_ready(self, name: str, proc, url: str,
                   log_path: str) -> RemoteServer:
        """Block until the process answers ``/v1/spec``; raises with its
        log's tail when it exits or times out first."""
        deadline = time.monotonic() + self.spawn_timeout
        last_err: Optional[Exception] = None
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"fleet worker '{name}' exited rc={proc.returncode} "
                    f"before readiness; log {log_path}:\n"
                    f"{_tail(log_path)}")
            try:
                remote = RemoteServer(url, proc=proc, name=name,
                                      stream_timeout=self.stream_timeout,
                                      log_path=log_path)
            except Exception as e:  # noqa: BLE001 - not listening yet
                last_err = e
                time.sleep(0.1)
                continue
            self.replicas[name] = remote
            return remote
        proc.kill()
        proc.wait(timeout=10.0)
        raise RuntimeError(
            f"fleet worker '{name}' not ready after {self.spawn_timeout}s "
            f"({last_err}); log {log_path}:\n{_tail(log_path)}")

    def spawn(self, name: str, role: str,
              ckpt: Optional[str] = None) -> RemoteServer:
        """One replica process, ready.  With ``ckpt`` it loads its
        weights from that ``.pth`` (or the directory holding
        ``model.pth``) in place of the fleet's: the deploy path spawns
        new-generation replicas so."""
        return self.wait_ready(name, *self.launch(name, role, ckpt))

    def start(self) -> "Fleet":
        """Every replica of ``roles``, the processes started together."""
        launched = [(name, *self.launch(name, role)) for name, role in
                    ((self._next_name(role), role) for role in self.roles)]
        try:
            for name, proc, url, log_path in launched:
                self.wait_ready(name, proc, url, log_path)
        except BaseException:
            for _, proc, _, _ in launched:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=10.0)
            self.replicas.clear()
            raise
        return self

    def factory(self, role: str) -> RemoteServer:
        """A ``server_factory``: each call spawns a real process."""
        return self.spawn(self._next_name(role), role)

    def deploy_factory(self, ckpt: str):
        """A ``server_factory`` bound to a checkpoint: ``Router.deploy``'s
        new-generation replicas, each a process loading ``ckpt``."""
        def spawn(role: str) -> RemoteServer:
            return self.spawn(self._next_name(role), role, ckpt=ckpt)

        return spawn

    def kill(self, name: str) -> None:
        """``SIGKILL`` one replica process (chaos)."""
        self.replicas[name].kill_process()

    def stop(self) -> None:
        for remote in self.replicas.values():
            try:
                remote.close()
            except Exception:  # noqa: BLE001
                pass
        self.replicas.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def make_router(self, **router_kwargs):
        """A ``Router`` over the fleet, owning the ``RemoteServer``s
        (``close`` shuts the processes down), polling their health over
        HTTP."""
        from ml_trainer_tpu_torch.serving.router import Router

        router_kwargs.setdefault("own_servers", True)
        router = Router(
            replicas=dict(self.replicas),
            replica_urls={n: r.url for n, r in self.replicas.items()},
            **router_kwargs)
        # Router.deploy spawns its new generation through
        # ``deploy_factory``.
        router.fleet = self
        return router


def _tail(path: str, max_bytes: int = 4096) -> str:
    try:
        with open(path, "rb") as fp:
            fp.seek(0, os.SEEK_END)
            fp.seek(max(fp.tell() - max_bytes, 0))
            return fp.read().decode("utf-8", errors="replace")
    except OSError:
        return ""


# -- the worker -------------------------------------------------------------


def _worker_main(argv: Optional[List[str]] = None) -> int:
    """``python -m ml_trainer_tpu_torch.serving.fleet --worker ...``: the
    model from the seed (or ``--ckpt``), a ``Server`` over HTTP, then
    block until killed or ``/admin/shutdown``."""
    import argparse

    parser = argparse.ArgumentParser(prog="ml_trainer_tpu_torch.serving.fleet")
    parser.add_argument("--worker", action="store_true", required=True)
    parser.add_argument("--name", default="replica")
    parser.add_argument("--role", default="both")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--model", default="gpt2_tiny")
    parser.add_argument("--max-len", type=int, default=256)
    parser.add_argument("--max-batch", type=int, default=4)
    parser.add_argument("--max-queue", type=int, default=64)
    parser.add_argument("--kv-page-size", type=int, default=16)
    parser.add_argument("--kv-pages", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--prefill-chunk", type=int, default=0)
    parser.add_argument("--no-prefix-cache", action="store_true")
    parser.add_argument("--paged-kernel", action="store_true")
    parser.add_argument("--ckpt", default=None,
                        help="load the weights from this .pth (written by "
                        "the port) instead of the seeded init")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from ml_trainer_tpu_torch.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:  # no card: never serve on the CPU unasked
        print(f"fleet worker '{args.name}': {e}", file=sys.stderr,
              flush=True)
        return 3
    from ml_trainer_tpu_torch.convert import init_model
    from ml_trainer_tpu_torch.models import get_model
    from ml_trainer_tpu_torch.serving.api import Server
    from ml_trainer_tpu_torch.utils import load_model

    if args.ckpt:
        model = get_model(args.model, device=device, max_len=args.max_len)
        load_model(model, args.ckpt)
    else:
        model = init_model(args.model, seed=args.seed, device=device,
                           max_len=args.max_len)
    model.eval()
    server = Server(model, max_batch=args.max_batch,
                    max_queue=args.max_queue,
                    kv_page_size=args.kv_page_size, kv_pages=args.kv_pages,
                    paged_kernel=args.paged_kernel, role=args.role,
                    prefill_chunk=args.prefill_chunk,
                    prefix_cache=not args.no_prefix_cache, device=device)
    server.transport = "http"  # /admin/shutdown ends this process
    server.name = args.name
    host, port = server.serve_http(args.host, args.port)
    print("FLEET_WORKER_READY " + json.dumps({
        "name": args.name, "url": f"http://{host}:{port}",
        "pid": os.getpid(), "role": args.role, "device": str(device)}),
        flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(_worker_main())
