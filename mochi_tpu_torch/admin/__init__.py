"""Admin/observability HTTP shell.

Parity with the reference's L6 app shell (Spring Boot REST ``/json`` +
static Bootstrap UI, ``controller/MainController.java:15-21``,
``resources/static/index.html`` — SURVEY.md §2.8), rebuilt as a dependency-
free asyncio HTTP/1.1 server exposing replica status, metrics snapshots, and
cluster topology as JSON plus a small status page.
"""

from .http import AdminServer, ClientAdminServer  # noqa: F401
