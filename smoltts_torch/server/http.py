"""Minimal asyncio HTTP/1.1 server — the native runtime under the API layer.

The reference serves through FastAPI/uvicorn (mlx .../scripts/server.py); this
framework ships a dependency-free server built on asyncio streams: route
table, JSON bodies, fixed and chunked (streaming) responses. It exists so the
serving layer runs in a hermetic environment and so streaming PCM responses
are a plain async generator — no framework between the decode loop and the
socket. The port's copy of `smoltts_tpu/server/http.py`, plus `stop()`.
"""

from __future__ import annotations

import asyncio
import inspect
import json
import re
from typing import AsyncIterator, Callable, Dict, Optional, Tuple, Union
from urllib.parse import parse_qs, unquote, urlsplit


class Request:
    def __init__(self, method: str, path: str, query: Dict[str, list], headers: Dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.path_params: Dict[str, str] = {}

    def json(self):
        return json.loads(self.body.decode("utf-8")) if self.body else {}

    def query_param(self, name: str, default: Optional[str] = None) -> Optional[str]:
        vals = self.query.get(name)
        return vals[0] if vals else default


class Response:
    def __init__(
        self,
        body: Union[bytes, str] = b"",
        status: int = 200,
        content_type: str = "application/json",
        headers: Optional[Dict[str, str]] = None,
    ):
        self.body = body.encode() if isinstance(body, str) else body
        self.status = status
        self.content_type = content_type
        self.headers = headers or {}

    @classmethod
    def json(cls, obj, status: int = 200, headers=None) -> "Response":
        return cls(json.dumps(obj), status, "application/json", headers)

    @classmethod
    def error(cls, status: int, detail: str) -> "Response":
        return cls.json({"detail": detail}, status)


class StreamingResponse:
    def __init__(
        self,
        chunks: AsyncIterator[bytes],
        content_type: str = "application/octet-stream",
        headers: Optional[Dict[str, str]] = None,
        status: int = 200,
    ):
        self.chunks = chunks
        self.content_type = content_type
        self.headers = headers or {}
        self.status = status


_STATUS_TEXT = {200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed", 422: "Unprocessable Entity", 500: "Internal Server Error", 501: "Not Implemented"}


class HttpServer:
    def __init__(self):
        # routes: list of (method, regex, param_names, handler)
        self._routes = []
        self._serving = None  # (event loop, serve task) while run() serves
        self.on_stop = []  # callables run once the server has stopped

    def route(self, method: str, pattern: str):
        """Register a route; `{name}` segments become path params."""
        names = re.findall(r"\{(\w+)\}", pattern)
        regex = re.compile(
            "^" + re.sub(r"\{\w+\}", r"([^/]+)", pattern) + "$"
        )

        def deco(fn: Callable):
            self._routes.append((method.upper(), regex, names, fn))
            return fn

        return deco

    def get(self, pattern: str):
        return self.route("GET", pattern)

    def post(self, pattern: str):
        return self.route("POST", pattern)

    def _match(self, method: str, path: str) -> Tuple[Optional[Callable], Dict[str, str], bool]:
        path_found = False
        for m, regex, names, fn in self._routes:
            match = regex.match(path)
            if match:
                path_found = True
                if m == method:
                    return fn, dict(zip(names, [unquote(g) for g in match.groups()])), True
        return None, {}, path_found

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                request_line = await reader.readline()
                if not request_line:
                    break
                try:
                    method, target, _version = request_line.decode("latin-1").split()
                except ValueError:
                    break
                headers: Dict[str, str] = {}
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = line.decode("latin-1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                length = int(headers.get("content-length", "0"))
                body = await reader.readexactly(length) if length else b""

                parts = urlsplit(target)
                req = Request(method, parts.path, parse_qs(parts.query), headers, body)
                resp = await self._dispatch(req)
                await self._write_response(writer, resp)
                if headers.get("connection", "").lower() == "close":
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _dispatch(self, req: Request):
        fn, params, found = self._match(req.method, req.path)
        if fn is None:
            return Response.error(405 if found else 404, "Method Not Allowed" if found else "Not Found")
        req.path_params = params
        try:
            result = fn(req)
            if inspect.isawaitable(result):
                result = await result
            return result
        except json.JSONDecodeError:
            return Response.error(400, "invalid JSON body")
        except Exception as e:  # noqa: BLE001 — surface handler errors as 500s
            return Response.error(500, f"{type(e).__name__}: {e}")

    async def _write_response(self, writer: asyncio.StreamWriter, resp):
        status_line = f"HTTP/1.1 {resp.status} {_STATUS_TEXT.get(resp.status, 'Unknown')}\r\n"
        if isinstance(resp, StreamingResponse):
            headers = {
                "content-type": resp.content_type,
                "transfer-encoding": "chunked",
                **resp.headers,
            }
            writer.write(
                (status_line + "".join(f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n").encode()
            )
            await writer.drain()
            agen = resp.chunks
            try:
                async for chunk in agen:
                    if not chunk:
                        continue
                    writer.write(f"{len(chunk):X}\r\n".encode() + chunk + b"\r\n")
                    await writer.drain()
            finally:
                writer.write(b"0\r\n\r\n")
                await writer.drain()
        else:
            headers = {
                "content-type": resp.content_type,
                "content-length": str(len(resp.body)),
                **resp.headers,
            }
            writer.write(
                (status_line + "".join(f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n").encode()
                + resp.body
            )
            await writer.drain()

    async def serve(self, host: str = "0.0.0.0", port: int = 8000):
        server = await asyncio.start_server(self._handle, host, port)
        self._serving = (asyncio.get_running_loop(), asyncio.current_task())
        async with server:
            await server.serve_forever()

    def run(self, host: str = "0.0.0.0", port: int = 8000):
        """Serve until `stop()` (from another thread) or an interrupt."""
        try:
            asyncio.run(self.serve(host, port))
        except asyncio.CancelledError:
            pass  # stop() cancelled the serve task
        finally:
            self._serving = None
            for fn in self.on_stop:
                fn()

    def stop(self):
        """Stop a server that `run()` serves on another thread: open
        connections are cancelled, and `run()` returns once its loop closes."""
        if self._serving is not None:
            loop, task = self._serving
            loop.call_soon_threadsafe(task.cancel)
