"""A time limit per test, for the port's test files that start processes,
threads or servers: a test stuck on a join, a queue or a socket then fails
alone, with every thread's stack on stderr, instead of holding its worker
until the whole run is cut.

A test file takes it by importing the fixture, which is autouse:

    from time_limit import time_limit  # noqa: F401

``TIME_LIMIT_S`` is well above the slowest such test (a few seconds to
about 40 s on a CPU). The limit is an interval timer whose ``SIGALRM``
raises :class:`TimeLimitExceeded` in the test's thread (the main thread
of the pytest process or xdist worker); where no such signal can be set
(another thread), the stacks are still dumped when it expires, and the
test is left to run.
"""
import faulthandler
import signal
import sys
import threading

import pytest

TIME_LIMIT_S = 120


class TimeLimitExceeded(Exception):
    """A test ran past its time limit."""


@pytest.fixture(autouse=True)
def time_limit(request):
    limit = TIME_LIMIT_S
    if threading.current_thread() is not threading.main_thread() or \
            not hasattr(signal, "setitimer"):
        faulthandler.dump_traceback_later(limit, exit=False)
        try:
            yield
        finally:
            faulthandler.cancel_dump_traceback_later()
        return

    def expire(signum, frame):
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        raise TimeLimitExceeded(
            "%s ran past its %d s limit; every thread's stack is on stderr"
            % (request.node.nodeid, limit))

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
