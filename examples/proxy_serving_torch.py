"""The paper's scenario, end to end, on the PyTorch port (``repro_torch``):
an L7 proxy in front of backends, with zero-copy payload forwarding —
written the way an unmodified proxy would be. It prints the lines
``examples/proxy_serving.py`` prints.

Part 1 (stream level): one ``LibraStack`` multiplexes several client↔backend
flows with *different* protocol parsers through the event-driven
``ProxyRuntime``. The router policy inspects ONLY header tokens; payloads
stay anchored in the "kernel" pool and move to the egress socket by VPI
ownership transfer. Note there is no pool/registry/counter plumbing at any
call-site — just sockets.

Part 2 (serving level): the same stack design carried into the LLM serving
engine — a router reads request headers, prefill anchors the payload KV
(``flash_attention`` on the card), the decode steps read it in place
(``paged_attention``), and the chosen backend takes ownership via VPI with
zero payload movement.

  python examples/proxy_serving_torch.py                        # on a GPU
  PYTHONPATH=src python examples/proxy_serving_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import (  # noqa: E402
    LibraStack,
    ProxyRuntime,
    build_chunked_message,
    build_delimited_message,
    build_message,
)
from repro_torch.core.parser import TokenStreamParser  # noqa: E402
from repro_torch.kernels.ops import checked_device  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import LibraEngine  # noqa: E402

HEADER = 4   # routing prefix tokens (the HTTP-header analogue)


def stream_proxy(device) -> None:
    rng = np.random.default_rng(0)
    stack = LibraStack(n_shards=4, pages_per_shard=256, page_size=16,
                       device=device)
    rt = ProxyRuntime(stack, scheduler="round-robin", tick_every=8)

    # three protocols behind one proxy; the framed protocols route each
    # message to one of two backends by its first *header* token (the L7
    # policy — past the framing: [MAGIC, mlen, plen, hdr...] vs [hdr...]);
    # the chunked flow has no routing tag and uses a single backend
    flows = []
    route_tok = {"length-prefixed": 3, "delimiter": 0}
    for proto, build in (("length-prefixed", build_message),
                         ("delimiter", build_delimited_message),
                         ("chunked", None)):
        client = stack.socket(proto)
        n_backends = 2 if proto in route_tok else 1
        backends = [stack.socket(proto) for _ in range(n_backends)]
        router = None
        if proto in route_tok:
            router = (lambda buf, n, b=backends, i=route_tok[proto]:
                      b[int(buf[i]) % 2])
        rt.channel(client, backends, router=router, budget=64, name=proto)
        flows.append((proto, build, client, backends))

    n_msgs, payload_tokens = 8, 96
    for proto, build, client, _ in flows:
        for i in range(n_msgs):
            meta = np.full(HEADER, 100 + (i % 2))
            payload = rng.integers(1000, 2000, payload_tokens)
            if build is None:
                client.deliver(build_chunked_message(
                    [payload[:48], payload[48:]]))
            else:
                client.deliver(build(meta, payload))

    forwarded = rt.run()
    c = stack.counters
    print("--- stream proxy (3 protocols, 5 backends, one stack) ---")
    for ch in rt.channels:
        print(f"  {ch.name:16s} messages={ch.stats.messages:3d} "
              f"logical={ch.stats.logical_bytes} "
              f"partial_sends={ch.stats.partial_sends}")
    print(f"messages forwarded: {forwarded}")
    print(f"user-boundary copies: meta={c.meta_copied} full={c.full_copied} "
          f"tokens (payload stayed in the pool)")
    print(f"payload anchored once: {c.anchored} tokens; "
          f"ownership-transferred: {c.zero_copied} tokens")
    rt.shutdown()
    assert stack.alloc.free_pages == stack.alloc.total_pages


def serving_proxy(device, params=None, model=None) -> LibraEngine:
    """Serve 8 routed requests. ``model`` defaults to the reduced
    libra-proxy-125m and ``params`` to its ``init_params(0)`` on
    ``device``; returns the engine, its requests in ``completed``."""
    if model is None:
        model = build_model(get_reduced("libra-proxy-125m"), page_size=8)
    cfg = model.cfg
    if params is None:
        params = model.init_params(0, device=device)
    parser = TokenStreamParser(header_len=HEADER)

    # one engine instance = one LibraStack serving two logical backends
    # (route 0 / route 1) behind the router
    eng = LibraEngine(model, params, max_batch=4, max_len=96, page_size=8,
                      parser=parser, device=device)
    rng = np.random.default_rng(0)

    n_req, hdr_bytes = 8, 0
    for i in range(n_req):
        route_tag = i % 2
        header = np.full(HEADER, 100 + route_tag)
        payload = rng.integers(1, cfg.vocab_size - 1, 40)
        prompt = np.concatenate([header, payload])

        # --- router: reads ONLY the header (selective copy) ---
        decision = int(header[0]) - 100
        hdr_bytes += header.nbytes

        # --- ingress: prefill anchors the payload KV, returns a handle ---
        r = eng.submit(prompt, max_new_tokens=6)
        while r.handle is None:   # admission may wait for a free slot
            eng.step()

        # --- zero-copy forwarding: backend takes ownership via VPI ---
        if not r.done:
            h = eng.forward_handle(r)
            eng.release_handle(h)  # backend done with the shared context
        print(f"req {r.rid}: route={decision} header={header[:2]}... "
              f"anchored {len(r.handle.pages) if r.handle else 0} pages "
              f"(vpi={r.handle.vpi & 0xffff:#x}...)" if r.handle else "")
    eng.run()

    s = eng.stats
    print("\n--- serving proxy summary ---")
    print(f"requests routed: {n_req}; header bytes inspected: {hdr_bytes}")
    print(f"payload KV forwarded zero-copy: {s.zero_copy_bytes/1e6:.2f} MB")
    print("payload bytes moved through the router: 0 (VPI handoff)")
    print(f"standard proxy would re-prefill {s.anchored_bytes/1e6:.2f} MB "
          f"of context at the backend")
    print(f"stack counters (tokens): {eng.stack.counters}")
    return eng


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = checked_device(ap.parse_args(argv).device)
    stream_proxy(device)
    serving_proxy(device)


if __name__ == "__main__":
    main()
