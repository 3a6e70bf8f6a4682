"""The serve cell's clients: one process, one thread, asyncio.

Run by ``serve_clients.py`` as ``python3 serve_load.py``; it imports the
standard library only.  Protocol on standard input, one JSON line each:

1. ``{"port", "sids", "steps", "warm_rounds", "timeout", "rate_per_s"}``:
   open an HTTP/1.1 connection to every session, step every session
   ``warm_rounds`` times (all at once, each waiting for its own reply),
   and print ``warm``;
2. ``{"start", "end", "deadline"}`` (``time.monotonic()`` readings, the
   same clock in every process), then an open loop until ``end``: session
   i's k-th step is due at ``start + (k + i / S) * P`` with P = S /
   ``rate_per_s`` for S sessions, the same schedule for every seed; each
   is sent when due, whether or not the session's last step has been
   answered, on an idle connection of the session's (reopened where it
   has been idle ``IDLE_SECONDS``), or on a new one kept for the session
   after.  Replies are awaited until ``deadline``.

Then it prints one JSON line: every request as ``[session index, due,
done, status, epoch, digest, warm, sent]``; ``status`` is null for a
request that got no reply (a broken connection or the deadline).
"""

import asyncio
import json
import sys
import time

# A connection idle this long is closed rather than reused: the server
# closes one idle for 30 s, and a step sent on a connection it closed
# would never be answered.
IDLE_SECONDS = 10.0


class Conn:
    def __init__(self, port: int) -> None:
        self.port = port
        self.reader = self.writer = None
        self.used = time.monotonic()

    async def post(self, path: str, doc: dict):
        if self.writer is None:
            self.reader, self.writer = await asyncio.open_connection("127.0.0.1", self.port)
        body = json.dumps(doc).encode()
        self.writer.write(
            f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body
        )
        await self.writer.drain()
        status = int((await self.reader.readline()).split()[1])
        length, close = 0, False
        while True:
            line = await self.reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            key, _, value = line.decode("latin-1").partition(":")
            key = key.strip().lower()
            if key == "content-length":
                length = int(value)
            elif key == "connection" and value.strip().lower() == "close":
                close = True
        payload = await self.reader.readexactly(length)
        if close:
            self.close()
        return status, json.loads(payload) if payload else {}

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        self.reader = self.writer = None


async def step(i: int, conn: Conn, spec: dict, records: list, warm: bool, due: float, deadline: float):
    sent = time.monotonic()
    status = epoch = digest = None
    try:
        timeout = max(0.0, min(spec["timeout"], deadline - sent))
        status, doc = await asyncio.wait_for(
            conn.post(f"/boards/{spec['sids'][i]}/step", {"steps": spec["steps"]}), timeout)
        epoch, digest = doc.get("epoch"), doc.get("digest")
    except (OSError, ValueError, IndexError, asyncio.IncompleteReadError, asyncio.TimeoutError):
        conn.close()
    records.append([i, due, time.monotonic(), status, epoch, digest, warm, sent])


async def open_loop(spec: dict, go: dict, records: list, conns: list):
    n = len(spec["sids"])
    period = n / spec["rate_per_s"]
    due = sorted((go["start"] + (k + i / n) * period, i)
                 for i in range(n) for k in range(int((go["end"] - go["start"]) / period) + 1))
    idle = [[c] for c in conns]  # each session's connections not in use
    tasks = []
    for t, i in due:
        if t >= go["end"]:
            break
        await asyncio.sleep(max(0.0, t - time.monotonic()))
        tasks.append(asyncio.ensure_future(one_request(i, spec, records, t, go["deadline"], idle[i])))
    for task in tasks:
        await task
    for pool in idle:
        for c in pool:
            c.close()


async def one_request(i: int, spec: dict, records: list, due: float, deadline: float, idle: list):
    conn = idle.pop() if idle else Conn(spec["port"])
    if time.monotonic() - conn.used > IDLE_SECONDS:
        conn.close()
    await step(i, conn, spec, records, False, due, deadline)
    conn.used = time.monotonic()
    idle.append(conn)


async def main() -> None:
    loop = asyncio.get_running_loop()
    spec = json.loads(await loop.run_in_executor(None, sys.stdin.readline))
    conns = [Conn(spec["port"]) for _ in spec["sids"]]
    records: list = []
    for _ in range(spec["warm_rounds"]):
        await asyncio.gather(*(step(i, c, spec, records, True, time.monotonic(), time.monotonic() + spec["timeout"])
                               for i, c in enumerate(conns)))
    print("warm", flush=True)
    go = json.loads(await loop.run_in_executor(None, sys.stdin.readline))
    await open_loop(spec, go, records, conns)
    print(json.dumps(records), flush=True)


if __name__ == "__main__":
    asyncio.run(main())
