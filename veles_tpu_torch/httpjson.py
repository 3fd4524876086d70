"""JSON-over-HTTP plumbing for the serving endpoints.

The part of ``veles_tpu/httpjson.py`` the generate route uses.  Error
taxonomy: everything wrong with the *request* raises
:class:`ClientError` (a ValueError), which handlers answer with HTTP
400; any other exception is a *server* fault and surfaces as a 500 with
a generic body, never the traceback.
"""

import json
from http.server import BaseHTTPRequestHandler

__all__ = ["ClientError", "JsonRequestHandler"]


class ClientError(ValueError):
    """The request itself is malformed — answer 400, not 500."""


class JsonRequestHandler(BaseHTTPRequestHandler):
    """Quiet handler with JSON helpers."""

    def log_message(self, *args):
        pass

    def send_json(self, code, payload, headers=None):
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(data)

    def read_json_body(self):
        """The request body parsed as JSON; ClientError when it is not."""
        length = int(self.headers.get("Content-Length", 0))
        try:
            return json.loads(self.rfile.read(length))
        except ValueError:
            raise ClientError("body is not valid JSON")
