"""Elastic membership for the launcher (a copy of
paddle_tpu/distributed/launch/elastic.py, standard library only) — the
KV-master analog of the reference's etcd-backed elastic stack:

- `ElasticMaster` plays etcd + ETCDMaster
  (launch/controllers/master.py:177): a tiny TCP KV registry holding
  job members under TTL leases.
- Members register and keep their lease alive with heartbeats
  (fleet/elastic/manager.py:254-267 lease_heartbeat analog).
- The live set is computed from unexpired leases (manager.py:422
  `_match` host-list matching analog).
- At each restart boundary the launcher relaunches with the ACTUAL
  survivor count — scale-in (manager.py:521 `_update_elastic_scale_in`)
  — and absorbs newly registered members — scale-out / rejoin
  (manager.py:498 `_update_elastic_scale_out`).

Two membership classes, mirroring how the reference distinguishes the
local pod from remote hosts:

- **launcher-owned members** (the ranks this launcher spawned): managed
  synchronously — the parent has perfect liveness information, so their
  lease is permanent and failure is reported via `leave()`. This is the
  single-host analog of a node manager updating etcd for its own pods.
- **external members** (a recovered host rejoining the job via
  `python -m paddle_tpu_torch.distributed.launch.elastic join`):
  TTL-leased, kept alive only by heartbeats — exactly the etcd lease
  mechanism, because there is no parent/child relationship to rely on. Elastic
  restart coordination spans one launcher's pod (node 0); per-host
  launchers restart independently.
"""
from __future__ import annotations

# Wire format: newline-delimited JSON, deliberately NOT the rpc tier's
# length-prefixed pickle framing — membership records are tiny, and a
# human (or the `launch.elastic live` CLI) can poke the registry with
# netcat when debugging a wedged pod; pickle would also let a rogue
# host on the rendezvous port execute code in the launcher.
import hmac
import json
import os
import socket
import socketserver
import threading
import time

__all__ = ["ElasticMaster", "ElasticClient", "ElasticAgent"]

_DEFAULT_TTL = 6.0

# wire commands that mutate membership/KV state: with a job token set,
# these require it. Reads (live/get) stay open — they are the debugging
# surface ("poke with netcat") and leak only what the launcher already
# prints. heartbeat IS authed: a rogue peer replaying heartbeats could
# otherwise keep a dead joiner's lease alive forever, and the next
# elastic resize would absorb the phantom into the new world size
# (ElasticClient attaches the token to every call, so no legitimate
# caller changes).
_AUTHED_CMDS = ("register", "heartbeat", "leave", "put")


def _send(sock, obj):
    sock.sendall((json.dumps(obj) + "\n").encode())


def _recv(f):
    line = f.readline()
    if not line:
        raise ConnectionError("elastic master closed the connection")
    return json.loads(line)


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        try:
            req = _recv(self.rfile)
        except (ConnectionError, json.JSONDecodeError):
            return
        master: "ElasticMaster" = self.server.master  # type: ignore
        cmd = req.get("cmd")
        member = req.get("member")
        now = time.monotonic()
        if master.token is not None and cmd in _AUTHED_CMDS \
                and not hmac.compare_digest(
                    str(req.get("token") or "").encode(
                        "utf-8", "surrogatepass"),
                    master.token.encode("utf-8", "surrogatepass")):
            # reject before taking the lock or touching state: a rogue
            # host on the rendezvous port must not be able to register
            # phantom members (inflating the next elastic resize),
            # evict live ones, or poison the KV space
            _send(self.connection,
                  {"ok": False, "error": f"unauthorized {cmd!r}: "
                   "missing/invalid job token"})
            return
        with master._lock:
            if cmd == "register":
                ttl = req.get("ttl")
                master._members[member] = {
                    "info": req.get("info") or {},
                    "deadline": None if ttl is None else now + float(ttl),
                    "ttl": ttl,
                }
                resp = {"ok": True}
            elif cmd == "heartbeat":
                m = master._members.get(member)
                if m is not None and m["ttl"] is not None \
                        and m["deadline"] <= now:
                    # an expired lease is terminal: a late heartbeat
                    # must not resurrect a member the resize already
                    # discounted — the host re-registers explicitly
                    master._members.pop(member)
                    m = None
                if m is None:
                    resp = {"ok": False}
                else:
                    if m["ttl"] is not None:
                        m["deadline"] = now + float(m["ttl"])
                    resp = {"ok": True}
            elif cmd == "leave":
                master._members.pop(member, None)
                resp = {"ok": True}
            elif cmd == "live":
                master._prune(now)
                # same shape as ElasticMaster.live(): _external marks
                # TTL-leased joiners vs launcher-owned members
                resp = {"ok": True, "members": {
                    k: dict(v["info"], _external=v["ttl"] is not None)
                    for k, v in master._members.items()}}
            elif cmd == "put":
                master._kv[req["key"]] = req.get("value")
                resp = {"ok": True}
            elif cmd == "get":
                resp = {"ok": True, "value": master._kv.get(req["key"])}
            else:
                resp = {"ok": False, "error": f"unknown cmd {cmd!r}"}
        _send(self.connection, resp)


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class ElasticMaster:
    """In-launcher KV membership registry (etcd + ETCDMaster analog).

    `token`: per-job shared secret (ADVICE r5). When set, wire-level
    register/leave/put must present it (the launcher generates one and
    hands it to ranks via PADDLE_ELASTIC_TOKEN; `launch.elastic join`
    reads the same env or --token). None or empty = open registry
    (tests, ad-hoc debugging) — an empty string must not LOOK
    authenticated while accepting every tokenless client."""

    def __init__(self, host="127.0.0.1", port=0, token=None):
        self.token = token or None
        self._members: dict = {}
        self._kv: dict = {}
        self._lock = threading.Lock()
        self._srv = _Server((host, port), _Handler)
        self._srv.master = self  # type: ignore
        threading.Thread(target=self._srv.serve_forever,
                         daemon=True).start()

    @property
    def endpoint(self) -> str:
        ip, port = self._srv.server_address[:2]
        return f"{ip}:{port}"

    # -- direct (in-process) access for the owning launcher ---------------
    def register(self, member, info=None, ttl=None):
        now = time.monotonic()
        with self._lock:
            self._members[member] = {
                "info": info or {},
                "deadline": None if ttl is None else now + float(ttl),
                "ttl": ttl,
            }

    def leave(self, member):
        with self._lock:
            self._members.pop(member, None)

    def clear_owned(self):
        """Drop every launcher-owned (permanent-lease) member — called
        at each attempt boundary so stale rank identities from the
        previous (larger) pod can't inflate the next live-set count.
        External TTL members (rejoiners) survive."""
        with self._lock:
            self._members = {k: v for k, v in self._members.items()
                             if v["ttl"] is not None}

    def _prune(self, now):
        """Drop expired leases for good (must hold the lock). Ghost
        joiners would otherwise linger forever and a late heartbeat
        could resurrect one the resize already discounted."""
        self._members = {              # guarded-by: _lock
            k: v for k, v in self._members.items()
            if v["deadline"] is None or v["deadline"] > now}

    def live(self) -> dict:
        with self._lock:
            self._prune(time.monotonic())
            return {k: dict(v["info"], _external=v["ttl"] is not None)
                    for k, v in self._members.items()}

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


class ElasticClient:
    """TCP client for a remote ElasticMaster (external members and
    node-rank launchers use this; the owning launcher talks directly)."""

    def __init__(self, endpoint: str, timeout: float = 10.0,
                 token=None):
        ip, port = endpoint.rsplit(":", 1)
        self._addr = (ip, int(port))
        self._timeout = timeout
        # default to the launcher-provided job token so in-job callers
        # (workers, rejoin agents) authenticate without plumbing
        self._token = token if token is not None \
            else os.environ.get("PADDLE_ELASTIC_TOKEN")

    def _call(self, check=True, **req):
        if self._token is not None:
            req.setdefault("token", self._token)
        with socket.create_connection(self._addr,
                                      timeout=self._timeout) as s:
            _send(s, req)
            resp = _recv(s.makefile("r"))
        if check and not resp.get("ok"):
            raise RuntimeError(
                f"elastic master error: {resp.get('error', resp)}")
        return resp

    def register(self, member, info=None, ttl=_DEFAULT_TTL):
        self._call(cmd="register", member=member, info=info or {},
                   ttl=ttl)

    def heartbeat(self, member) -> bool:
        """False (no raise) when the lease is gone — expired or
        absorbed into the pod; the member must re-register to count
        again."""
        return bool(self._call(check=False, cmd="heartbeat",
                               member=member)["ok"])

    def leave(self, member):
        self._call(cmd="leave", member=member)

    def live(self) -> dict:
        return self._call(cmd="live")["members"]

    def put(self, key, value):
        self._call(cmd="put", key=key, value=value)

    def get(self, key):
        return self._call(cmd="get", key=key)["value"]


class ElasticAgent:
    """Register an external member and keep its lease alive with a
    background heartbeat thread (manager.py lease_heartbeat analog).
    Used by a recovered host to rejoin the job, and by --node-rank
    launchers to report node liveness to node 0's master."""

    def __init__(self, endpoint: str, member: str, info=None,
                 ttl: float = _DEFAULT_TTL, interval: float | None = None,
                 token=None):
        self.client = ElasticClient(endpoint, token=token)
        self.member = member
        self.ttl = ttl
        self.interval = interval if interval is not None else ttl / 3.0
        self._stop = threading.Event()
        self.client.register(member, info=info, ttl=ttl)
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self._thread.start()

    def _beat(self):
        while not self._stop.wait(self.interval):
            try:
                # a failed heartbeat (expired or ABSORBED into the pod
                # at a restart boundary) is terminal for this lease —
                # re-registering here would double-count an absorbed
                # member at the next resize, so the agent retires
                if not self.client.heartbeat(self.member):
                    return
            except OSError:
                pass  # master briefly unreachable; keep trying

    def stop(self, leave=True):
        self._stop.set()
        self._thread.join(timeout=5)
        if leave:
            try:
                self.client.leave(self.member)
            except OSError:
                pass


def main(argv=None):
    """`python -m paddle_tpu_torch.distributed.launch.elastic join --master
    ip:port --member name [--ttl s] [--hold s]` — register a member and
    heartbeat until killed (a recovered host announcing itself)."""
    import argparse

    p = argparse.ArgumentParser(prog="launch.elastic")
    p.add_argument("action", choices=["join", "live"])
    p.add_argument("--master", required=True)
    p.add_argument("--member", default=None)
    p.add_argument("--ttl", type=float, default=_DEFAULT_TTL)
    p.add_argument("--hold", type=float, default=0,
                   help="seconds to keep heartbeating (0 = forever)")
    p.add_argument("--token", default=None,
                   help="per-job registry token (default: "
                        "$PADDLE_ELASTIC_TOKEN; required to join a "
                        "launcher-started registry)")
    args = p.parse_args(argv)
    if args.action == "live":
        print(json.dumps(
            ElasticClient(args.master, token=args.token).live()))
        return 0
    member = args.member or f"joiner-{socket.gethostname()}"
    agent = ElasticAgent(args.master, member, ttl=args.ttl,
                         token=args.token)
    print(f"joined as {member}", flush=True)
    try:
        if args.hold:
            time.sleep(args.hold)
        else:
            while True:
                time.sleep(60)
    except KeyboardInterrupt:
        pass
    finally:
        agent.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
