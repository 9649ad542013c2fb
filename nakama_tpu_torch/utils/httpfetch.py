"""Shared outbound HTTP(S) helper for the social, Satori and IAP clients
and the gRPC gateway's loopback calls.

The port's copy of the JAX package's `utils/httpfetch.py`, with the same
contract — ``fetch(url, method, headers, body) -> (status, bytes)`` —
over the standard library instead of `aiohttp`: HTTP/1.1 on
`asyncio.open_connection`, TLS through `ssl` (the default context,
`_ssl_context()`), bodies framed by `Content-Length`, `chunked` or the
connection's close, `gzip`/`deflate` content decoded, and redirects
followed as `aiohttp`'s `session.request` follows them by default
(303, and 301/302 after a POST, continue as a GET without the body; the
10th redirect in a row raises). Connections are kept alive in one pool
per event loop (the JAX helper keeps one session per loop, the
reference one http.Client per client, social/social.go NewClient);
pools of closed loops are dropped. `fetch_response` is `fetch` with the
response's headers (names lower-cased) beside its status and body, over
the same pool; `close_idle` closes this loop's idle connections to one
origin.
"""

from __future__ import annotations

import asyncio
import ssl
import urllib.parse
import zlib

MAX_REDIRECTS = 10
_REDIRECTS = (301, 302, 303, 307, 308)
# Idle keep-alive connections kept per (scheme, host, port).
_POOL_PER_HOST = 8


class FetchError(OSError):
    """The response could not be read (a malformed head or body, or too
    many redirects)."""


_pools: dict[int, tuple[asyncio.AbstractEventLoop, dict]] = {}
_context: ssl.SSLContext | None = None


def _ssl_context() -> ssl.SSLContext:
    """The TLS context of every https request: the system's trusted
    roots, hostname checked."""
    global _context
    if _context is None:
        _context = ssl.create_default_context()
    return _context


def _pool() -> dict:
    """This loop's idle connections by (scheme, host, port); the pools of
    closed loops are dropped with their connections."""
    loop = asyncio.get_running_loop()
    key = id(loop)
    entry = _pools.get(key)
    if entry is None or entry[0] is not loop:
        for k, (other, conns) in list(_pools.items()):
            if other.is_closed():
                _pools.pop(k, None)
                for idle in conns.values():
                    for _, writer in idle:
                        try:
                            writer.transport.abort()
                        except RuntimeError:
                            # Its loop is closed and can schedule nothing:
                            # the socket closes with the dropped transport.
                            pass
        entry = _pools[key] = (loop, {})
    return entry[1]


async def fetch(
    url: str,
    method: str = "GET",
    headers: dict | None = None,
    body: bytes | None = None,
) -> tuple[int, bytes]:
    status, _, data = await fetch_response(url, method, headers, body)
    return status, data


async def fetch_response(
    url: str,
    method: str = "GET",
    headers: dict | None = None,
    body: bytes | None = None,
) -> tuple[int, dict, bytes]:
    """`fetch`, with the response's headers: (status, headers, body)."""
    # The 10th redirect is an error, not followed (as aiohttp's is).
    for _ in range(MAX_REDIRECTS):
        status, resp_headers, data = await _request(url, method, headers, body)
        location = resp_headers.get("location")
        if status not in _REDIRECTS or not location:
            return status, resp_headers, data
        url = urllib.parse.urljoin(url, location)
        if status == 303 or (status in (301, 302) and method == "POST"):
            if method != "HEAD":
                method = "GET"
            body = None
    raise FetchError(f"too many redirects ({MAX_REDIRECTS}): {url}")


def close_idle(scheme: str, host: str, port: int) -> int:
    """Close this loop's idle connections to one origin; how many."""
    idle = _pool().pop((scheme, host, port), [])
    for _, writer in idle:
        writer.close()
    return len(idle)


async def _request(url, method, headers, body):
    parts = urllib.parse.urlsplit(url)
    scheme = parts.scheme.lower()
    if scheme not in ("http", "https"):
        raise FetchError(f"unsupported URL scheme {parts.scheme!r}")
    host = parts.hostname or ""
    port = parts.port or (443 if scheme == "https" else 80)
    target = parts.path or "/"
    if parts.query:
        target += "?" + parts.query
    default_port = port == (443 if scheme == "https" else 80)
    host_header = host if ":" not in host else f"[{host}]"
    if not default_port:
        host_header += f":{port}"
    given = {k.lower(): k for k in (headers or {})}
    lines = [f"{method} {target} HTTP/1.1"]
    if "host" not in given:
        lines.append(f"Host: {host_header}")
    if "accept" not in given:
        lines.append("Accept: */*")
    if "accept-encoding" not in given:
        lines.append("Accept-Encoding: gzip, deflate")
    data = bytes(body) if body is not None else b""
    if body is not None or method in ("POST", "PUT", "PATCH"):
        lines.append(f"Content-Length: {len(data)}")
    lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
    request = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + data

    key = (scheme, host, port)
    idle = _pool().setdefault(key, [])
    while idle:
        # A kept-alive connection the server has since closed fails on
        # its first read: send again on a fresh one (nothing was read).
        reader, writer = idle.pop()
        if reader.at_eof() or writer.is_closing():
            writer.close()
            continue
        try:
            return await _exchange(key, reader, writer, request, method)
        except (ConnectionError, asyncio.IncompleteReadError, _Stale):
            writer.close()
    reader, writer = await asyncio.open_connection(
        host, port,
        ssl=_ssl_context() if scheme == "https" else None,
        server_hostname=host if scheme == "https" else None,
    )
    try:
        return await _exchange(key, reader, writer, request, method)
    except _Stale as e:
        writer.close()
        raise ConnectionError("connection closed before a response") from e


class _Stale(Exception):
    """The connection closed before any byte of the response."""


async def _exchange(key, reader, writer, request: bytes, method: str):
    try:
        writer.write(request)
        await writer.drain()
        status_line = await reader.readline()
    except BaseException:
        writer.close()
        raise
    if not status_line:
        raise _Stale()
    try:
        status, headers, data, reusable = await _read_response(
            reader, status_line, method)
    except BaseException:
        writer.close()
        raise
    if reusable:
        idle = _pool().setdefault(key, [])
        if len(idle) < _POOL_PER_HOST:
            idle.append((reader, writer))
        else:
            writer.close()
    else:
        writer.close()
    return status, headers, data


async def _read_response(reader, status_line: bytes, method: str):
    try:
        version, code = status_line.decode("latin-1").split(None, 2)[:2]
        status = int(code)
    except ValueError as e:
        raise FetchError(f"malformed status line {status_line[:80]!r}") from e
    headers: dict[str, str] = {}
    while True:
        line = await reader.readline()
        if not line:
            raise FetchError("connection closed inside the response head")
        if line in (b"\r\n", b"\n"):
            break
        name, _, value = line.decode("latin-1").partition(":")
        name = name.strip().lower()
        value = value.strip()
        headers[name] = f"{headers[name]}, {value}" if name in headers else value
    if 100 <= status < 200:
        # An interim response (100 Continue): the real one follows.
        return await _read_response(reader, await reader.readline(), method)
    connection = headers.get("connection", "").lower()
    keep = "close" not in connection and (
        version.upper() != "HTTP/1.0" or "keep-alive" in connection)
    if method == "HEAD" or status in (204, 304):
        data = b""
    elif "chunked" in headers.get("transfer-encoding", "").lower():
        data = await _read_chunked(reader)
    elif "content-length" in headers:
        try:
            length = int(headers["content-length"])
        except ValueError as e:
            raise FetchError("malformed Content-Length") from e
        data = await reader.readexactly(length)
    else:
        data = await reader.read()
        keep = False
    encoding = headers.get("content-encoding", "").lower().strip()
    if encoding in ("gzip", "x-gzip"):
        data = zlib.decompress(data, 16 + zlib.MAX_WBITS)
    elif encoding == "deflate":
        try:
            data = zlib.decompress(data)
        except zlib.error:
            data = zlib.decompress(data, -zlib.MAX_WBITS)
    return status, headers, data, keep


async def _read_chunked(reader) -> bytes:
    out = bytearray()
    while True:
        line = await reader.readline()
        if not line:
            raise FetchError("connection closed inside a chunked body")
        try:
            size = int(line.split(b";", 1)[0].strip(), 16)
        except ValueError as e:
            raise FetchError(f"malformed chunk size {line[:40]!r}") from e
        if size == 0:
            # Trailer fields, up to the blank line.
            while True:
                trailer = await reader.readline()
                if trailer in (b"\r\n", b"\n", b""):
                    return bytes(out)
        out += await reader.readexactly(size)
        await reader.readexactly(2)
