"""Real Kubernetes API client behind the ``KubeApi`` protocol.

Port of ``dlrover_tpu/cluster/kube_http.py`` (reference:
dlrover/python/scheduler/kubernetes.py:122, k8sClient — the official-SDK
singleton the reference master uses for pod CRUD — and
master/watcher/k8s_watcher.py:194, the resumable list-watch). The
master's platform contract is the small ``KubeApi``
protocol (cluster/kube.py:79); this module binds it to a live API
server with nothing but stdlib HTTP — create/delete/get/list plus a
chunked streaming watch with resourceVersion resume — so PodWatcher and
JobReconciler run unmodified against a real cluster, in-cluster
(service-account token + CA) or via a proxy/test server.

Scope notes:
- resourceVersions are opaque STRINGS in the k8s API (etcd's happen to
  be numeric). The resume machinery treats them as pass-through tokens:
  the last seen rv string is handed back verbatim on reconnect.
  ``WatchEvent.resource_version`` keeps its integer type for the
  in-process consumers (0 when the server's rv is non-numeric).
- On HTTP 410 Gone (rv expired from etcd's window) the watch raises
  ``WatchExpired``; callers relist and resume — the same contract the
  reference's watcher loop implements (k8s_watcher.py:219). PodWatcher
  and JobReconciler (cluster/kube.py) implement that relist inline.
- BOOKMARK events (the server periodically publishing a fresh rv with
  no object change) advance the resume token and are not surfaced.
"""

import json
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Iterator, List, Optional, Tuple, Union

from dlrover_tpu_torch.cluster.kube import KubeApi, WatchEvent, WatchExpired
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

__all__ = ["RealKubeApi", "WatchExpired"]

_IN_CLUSTER_TOKEN = "/var/run/secrets/kubernetes.io/serviceaccount/token"  # noqa: S105
_IN_CLUSTER_CA = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"

# kind -> (api prefix, plural). Core v1 kinds ride /api/v1; the
# operator's CRDs ride their group path (cluster/crd.py defines them).
_BUILTIN_PATHS: Dict[str, Tuple[str, str]] = {
    "Pod": ("/api/v1", "pods"),
    "Service": ("/api/v1", "services"),
    "ConfigMap": ("/api/v1", "configmaps"),
    "Secret": ("/api/v1", "secrets"),
    "Event": ("/api/v1", "events"),
    "ElasticJob": ("/apis/elastic.iml.github.io/v1alpha1", "elasticjobs"),
    "ScalePlan": ("/apis/elastic.iml.github.io/v1alpha1", "scaleplans"),
}


def _raw_rv(obj: Dict) -> str:
    """The rv as the opaque token the server gave us ("" if absent)."""
    return str(obj.get("metadata", {}).get("resourceVersion", "") or "")


def _parse_rv(obj: Dict) -> int:
    """Best-effort integer view of the rv for ``WatchEvent``'s int field
    (k8s documents rvs as opaque; non-numeric ones read as 0 here and
    the string token is what resume actually uses)."""
    try:
        return int(_raw_rv(obj) or 0)
    except ValueError:
        return 0


class RealKubeApi(KubeApi):
    """``KubeApi`` over raw HTTP to an API server.

    ``base_url``: e.g. ``https://10.0.0.1:443`` or an ``http://`` test
    server. ``token``/``token_path``: bearer auth (in-cluster default).
    ``ca_path``: server CA (in-cluster default); ``verify=False`` turns
    TLS verification off for dev proxies.
    """

    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        token_path: str = _IN_CLUSTER_TOKEN,
        ca_path: Optional[str] = None,
        verify: bool = True,
        timeout_s: float = 30.0,
        extra_paths: Optional[Dict[str, Tuple[str, str]]] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self._paths = dict(_BUILTIN_PATHS, **(extra_paths or {}))
        # collections a kind=None watch (JobReconciler) merges
        self.watch_kinds = ["ElasticJob", "ScalePlan"]
        if token is None:
            try:
                with open(token_path, encoding="utf-8") as fh:
                    token = fh.read().strip()
            except OSError:
                token = None
        self._token = token
        self._ctx: Optional[ssl.SSLContext] = None
        if self.base_url.startswith("https"):
            if not verify:
                self._ctx = ssl._create_unverified_context()  # noqa: S323
            else:
                ca = ca_path or _IN_CLUSTER_CA
                self._ctx = ssl.create_default_context(cafile=ca)

    # ---- plumbing ---------------------------------------------------------

    def _path(self, kind: str, namespace: str, name: str = "") -> str:
        if kind not in self._paths:
            raise KeyError(
                f"kind {kind!r} has no registered API path; pass "
                "extra_paths={kind: (api_prefix, plural)}"
            )
        prefix, plural = self._paths[kind]
        url = f"{prefix}/namespaces/{namespace}/{plural}"
        if name:
            url += f"/{name}"
        return url

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[Dict] = None,
        query: Optional[Dict[str, str]] = None,
        stream: bool = False,
        timeout_s: Optional[float] = None,
    ):
        url = self.base_url + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        resp = urllib.request.urlopen(  # noqa: S310
            req, timeout=timeout_s or self.timeout_s, context=self._ctx
        )
        if stream:
            return resp
        with resp:
            raw = resp.read()
        return json.loads(raw) if raw else {}

    @staticmethod
    def _selector(label_selector: Optional[Dict[str, str]]) -> Optional[str]:
        if not label_selector:
            return None
        return ",".join(f"{k}={v}" for k, v in sorted(label_selector.items()))

    # ---- KubeApi ----------------------------------------------------------

    def create(self, manifest: Dict) -> Dict:
        meta = manifest.get("metadata", {})
        ns = meta.get("namespace", "default")
        return self._request(
            "POST", self._path(manifest["kind"], ns), body=manifest
        )

    def update(self, manifest: Dict) -> Dict:
        meta = manifest.get("metadata", {})
        ns = meta.get("namespace", "default")
        return self._request(
            "PUT",
            self._path(manifest["kind"], ns, meta["name"]),
            body=manifest,
        )

    def update_status(
        self,
        kind: str,
        name: str,
        status: Dict,
        namespace: str = "default",
        obj: Optional[Dict] = None,
    ) -> Optional[Dict]:
        """PUT to the /status subresource path (the only write the API
        server persists .status from once the CRD enables it).
        ``obj``: the already-fetched object, to skip the extra GET the
        PUT body needs (callers typically just read it to diff)."""
        if obj is None:
            obj = self.get(kind, name, namespace)
        if obj is None:
            return None
        obj = dict(obj)
        obj["status"] = status
        return self._request(
            "PUT",
            self._path(kind, namespace, name) + "/status",
            body=obj,
        )

    def delete(self, kind: str, name: str, namespace: str = "default"):
        try:
            self._request("DELETE", self._path(kind, namespace, name))
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise

    def get(
        self, kind: str, name: str, namespace: str = "default"
    ) -> Optional[Dict]:
        try:
            return self._request("GET", self._path(kind, namespace, name))
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def list(
        self,
        kind: str,
        namespace: str = "default",
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[Dict]:
        query: Dict[str, str] = {}
        sel = self._selector(label_selector)
        if sel:
            query["labelSelector"] = sel
        out = self._request(
            "GET", self._path(kind, namespace), query=query or None
        )
        items = out.get("items", []) or []
        # item manifests in a list response omit kind/apiVersion; the
        # NodeEvent mapping and reconciler read obj["kind"]
        for it in items:
            it.setdefault("kind", kind)
        return items

    def list_rv(
        self, kind: str, namespace: str = "default"
    ) -> Union[int, str]:
        """The collection resourceVersion — the rv to start a watch at.

        Returned as int when numeric (every etcd-backed server today),
        otherwise as the opaque string; ``watch(since_rv=...)`` accepts
        either."""
        out = self._request("GET", self._path(kind, namespace))
        meta = {"metadata": out.get("metadata", {})}
        raw = _raw_rv(meta)
        return _parse_rv(meta) if raw.isdigit() else raw

    def watch(
        self,
        kind: Optional[str] = None,
        namespace: str = "default",
        label_selector: Optional[Dict[str, str]] = None,
        since_rv: int = 0,
        stop: Optional[threading.Event] = None,
        poll_s: float = 0.2,
    ) -> Iterator[WatchEvent]:
        """Streaming watch with reconnect-and-resume.

        Each API chunk is one JSON line {"type", "object"}; on a dropped
        connection the watch reopens from the last delivered rv. A 410
        raises WatchExpired for the caller to relist. ``kind=None``
        (the JobReconciler's all-kinds contract) fans out one
        per-collection watch per ``self.watch_kinds`` and merges the
        streams — a real API server only watches per collection. In
        that mode ``since_rv`` may be a {kind: rv} mapping: k8s
        resourceVersions are opaque PER-COLLECTION tokens, so resuming
        every pump from one collection's rv could be rejected (410
        loop) or mis-positioned on servers that don't share revisions
        across types.
        """
        if kind is None:
            yield from self._watch_merged(
                namespace, label_selector, since_rv, stop, poll_s
            )
            return
        if isinstance(since_rv, dict):
            since_rv = since_rv.get(kind, 0)
        stop = stop or threading.Event()
        rv = str(since_rv)  # opaque resume token, handed back verbatim
        sel = self._selector(label_selector)
        while not stop.is_set():
            query = {
                "watch": "1",
                "resourceVersion": rv,
                "allowWatchBookmarks": "true",
            }
            if sel:
                query["labelSelector"] = sel
            try:
                resp = self._request(
                    "GET",
                    self._path(kind, namespace),
                    query=query,
                    stream=True,
                    # long-poll read; re-established on server timeout
                    timeout_s=max(self.timeout_s, 60.0),
                )
            except urllib.error.HTTPError as e:
                if e.code == 410:
                    raise WatchExpired(
                        f"watch rv {rv} expired; relist and resume"
                    ) from e
                raise
            try:
                with resp:
                    for line in resp:
                        if stop.is_set():
                            return
                        line = line.strip()
                        if not line:
                            continue
                        ev = json.loads(line)
                        if ev.get("type") == "ERROR":
                            status = ev.get("object", {})
                            if status.get("code") == 410:
                                raise WatchExpired(
                                    f"watch rv {rv} expired (in-stream)"
                                )
                            raise RuntimeError(
                                f"watch error event: {status}"
                            )
                        obj = ev["object"]
                        rv = _raw_rv(obj) or rv
                        if ev.get("type") == "BOOKMARK":
                            # progress marker only: fresh rv, no change
                            continue
                        obj.setdefault("kind", kind)
                        yield WatchEvent(ev["type"], obj, _parse_rv(obj))
            except (TimeoutError, OSError, urllib.error.URLError) as e:
                if stop.is_set():
                    return
                logger.info(
                    "watch stream dropped (%s); resuming from rv %s", e, rv
                )
                stop.wait(poll_s)

    def _watch_merged(
        self, namespace, label_selector, since_rv, stop, poll_s
    ) -> Iterator[WatchEvent]:
        import queue

        outer = stop or threading.Event()
        # the pumps get their OWN stop event: setting the caller's event
        # on exit would make a WatchExpired unraisable to recover from
        # (the caller's resume loop checks that same event)
        inner = threading.Event()
        q: "queue.Queue" = queue.Queue()

        def pump(kind: str):
            try:
                for ev in self.watch(
                    kind=kind,
                    namespace=namespace,
                    label_selector=label_selector,
                    since_rv=since_rv,
                    stop=inner,
                    poll_s=poll_s,
                ):
                    q.put(ev)
            except Exception as e:  # noqa: BLE001 — surface via queue
                q.put(e)

        threads = [
            threading.Thread(target=pump, args=(k,), daemon=True)
            for k in self.watch_kinds
        ]
        for t in threads:
            t.start()
        try:
            while not outer.is_set():
                try:
                    item = q.get(timeout=poll_s)
                except queue.Empty:
                    continue
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            inner.set()
