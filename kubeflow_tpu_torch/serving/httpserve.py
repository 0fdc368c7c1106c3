"""A small threaded WSGI server from the standard library.

Plays the role of ``kubeflow_tpu/core/httpapi.serve`` for the port's
predictor: one thread per connection, so concurrent ``:generate`` callers
block in their own threads while the engine batches them.  No TLS,
keep-alive or WebSocket upgrade (the reference's gateway terminates those).
"""

from __future__ import annotations

import threading
from socketserver import ThreadingMixIn
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server


class _ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, *args):
        pass


def serve(app, port: int, host: str = "127.0.0.1"):
    """Serve ``app`` on ``host:port`` from a background thread; returns
    ``(server, thread)``.  ``server.shutdown()`` stops the loop and
    ``server.server_close()`` releases the socket.  Port 0 binds a free
    port (``server.server_port`` says which)."""
    httpd = make_server(host, port, app, server_class=_ThreadingWSGIServer,
                        handler_class=_QuietHandler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                              name="predictor-http")
    thread.start()
    return httpd, thread
