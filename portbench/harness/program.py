"""What the benchmark reads from the program, in one place: each eager launch of the
attention kernels (the shapes it was called at, and its device time), each graph
replay of a captured decode step and each decode call's first, eager step (their
device time). Recording is on only in a traced
window, and adds no device work to a call being captured into a CUDA graph.
"""

from __future__ import annotations


class LaunchRecorder:
    """Wraps the kernel launch wrappers of zoomearth_tpu_torch.ops to keep the inputs
    that decide each eager launch's work (copies of the small index tensors, taken on
    the device without a host wait) and to time the launch on the device timeline, and
    wraps the graph replays of the captured decode steps and each decode call's first,
    eager step (a key's first run of `StepGraphs.run`) to time each on the timeline. A
    decode step replayed from a graph calls no launch wrapper: of K3, the launches of
    each decode call's first, eager step are the ones kept and timed."""

    def __init__(self, timeline):
        self.timeline = timeline
        self.on = False
        self.records = []  # (kernel, the inputs that decide its work)
        self._undo = []

    def install(self):
        from zoomearth_tpu_torch.ops import flash_attention as k1
        from zoomearth_tpu_torch.ops import flash_causal as k2
        from zoomearth_tpu_torch.ops import flash_decode as k3
        from zoomearth_tpu_torch.runtime import graphs

        rec, tl = self, self.timeline

        def wrap(owner, attr, name, keep=None):
            orig = getattr(owner, attr)
            kind = "replay" if keep is None else "kernel"

            def recorded(*a, **kw):
                if not (rec.on and tl.timing()):  # off, on the CPU, or inside a graph capture
                    return orig(*a, **kw)
                if keep is not None:
                    rec.records.append((name, keep(*a, **kw)))
                token = tl.begin(kind, name)
                out = orig(*a, **kw)
                tl.end(token)
                return out

            recorded.__dict__.update(getattr(orig, "__dict__", {}))
            setattr(owner, attr, recorded)
            self._undo.append((owner, attr, orig))

        def seg(q, k, v, seg, return_lse=False):
            return (seg.detach().clone(), q.shape[1], q.shape[2], q.element_size())

        def seg_bwd(q, k, v, seg, out, dout, lse):
            return (seg.detach().clone(), q.shape[1], q.shape[2], q.element_size())

        def causal(q, k, v, positions, kv_len, ks=None, vs=None, return_lse=False):
            return (positions.detach().clone(), kv_len.detach().clone(), q.shape[2], k.shape[1], q.shape[3],
                    k.shape[2], q.element_size(), k.element_size())

        def causal_bwd(q, k, v, positions, kv_len, out, dout, lse):
            return (positions.detach().clone(), kv_len.detach().clone(), q.shape[2], k.shape[1], q.shape[3],
                    k.shape[2], q.element_size())

        def decode(q, k_cache, v_cache, kv_len, ks=None, vs=None):
            q3 = q[:, 0] if q.dim() == 4 else q
            return (kv_len.detach().clone(), k_cache.shape[2], q3.shape[1], k_cache.shape[1], q3.shape[2],
                    k_cache.element_size(), q3.element_size())

        wrap(k1, "segment_attention_cuda", "K1", seg)
        wrap(k1, "segment_attention_bwd_cuda", "K1-bwd", seg_bwd)
        wrap(k2, "causal_attention_cuda", "K2", causal)
        wrap(k2, "causal_attention_bwd_cuda", "K2-bwd", causal_bwd)
        wrap(k3, "decode_attention_cuda", "K3", decode)
        wrap(graphs.CapturedStep, "replay", "decode step")
        run = graphs.StepGraphs.run

        def eager_or_replayed(steps, key, fn, generators=()):
            if not (rec.on and tl.timing()) or key in steps.keys():  # a replay, timed as such
                return run(steps, key, fn, generators)
            token = tl.begin("eager", "decode step, eager")
            run(steps, key, fn, generators)
            tl.end(token)

        graphs.StepGraphs.run = eager_or_replayed
        self._undo.append((graphs.StepGraphs, "run", run))

    def uninstall(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    def bounds(self, peak_flops: float, peak_bytes: float):
        """{kernel: seconds at its bound} over the kept launches."""
        import collections

        from ..work import attention as W

        work = {"K1": W.segment_work, "K1-bwd": W.segment_work_bwd, "K2": W.causal_work,
                "K2-bwd": W.causal_work_bwd, "K3": W.decode_work}
        out = collections.Counter()
        for kernel, args in self.records:
            f, b = work[kernel](*[a.cpu() if hasattr(a, "cpu") else a for a in args])
            out[kernel] += max(f / peak_flops, b / peak_bytes)
        return out
