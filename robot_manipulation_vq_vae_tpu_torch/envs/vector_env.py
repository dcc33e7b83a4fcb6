"""Subprocess vectorized env pool (the port's counterpart of the JAX
package's ``envs/vector_env.py``; the reference uses tianshou's
``SubprocVectorEnv``): N env workers in their own processes, stepped in
lockstep, so that one batched policy query serves every env.

``shared_obs=True`` moves the observations through one shared-memory block
laid out as a batched array per observation key ([n_envs, *shape]), probed
from the first reset: each worker writes its row and the pipe carries only
(reward, done, info). ``step_batched`` and ``reset_batched`` return that
batch itself, valid until the next call of the pool; the per-env ``step``,
``reset`` and ``reset_to`` return copies, which the next step does not
overwrite.

Differences from the JAX package's pool:

* The workers start by ``spawn``: a fork after CUDA has started
  is fatal in torch. An env factory must therefore be picklable (a
  module-level function or ``utils.env_utils.EnvFactory``, not a closure),
  and a spawned worker begins with empty module globals (the factory fills
  what the env needs).
* A worker does not unregister the segment from the resource tracker.
  Under ``spawn`` the workers share the parent's tracker, which keeps one
  set of names: a worker's unregister would drop the parent's own
  registration, and the parent's ``unlink`` would then make the tracker
  print a ``KeyError``. A worker's attach registers the name again, which
  the set absorbs; ``close()`` unlinks it once, and nothing is left in
  ``/dev/shm``.
"""

import multiprocessing as mp
from multiprocessing import shared_memory

import numpy as np


def _attach_views(shm, spec, env_idx):
    """Per-key numpy views over this env's row of the batched block."""
    views = {}
    for key, (offset, shape, dtype) in spec.items():
        row_bytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        views[key] = np.ndarray(shape, dtype=dtype, buffer=shm.buf,
                                offset=offset + env_idx * row_bytes)
    return views


def _worker(remote, parent_remote, env_fn):
    parent_remote.close()
    env = env_fn()
    shm = None
    views = None

    def send_obs(obs, rest=()):
        if views is not None:
            for k, v in views.items():
                np.copyto(v, obs[k])
            remote.send(("__shm__",) + rest)
        else:
            remote.send(obs if not rest else (obs,) + rest)

    try:
        while True:
            cmd, data = remote.recv()
            if cmd == "step":
                obs, rew, done, info = env.step(data)
                send_obs(obs, (rew, done, info))
            elif cmd == "reset":
                send_obs(env.reset())
            elif cmd == "reset_to":
                send_obs(env.reset_to(data))
            elif cmd == "attach_shm":
                name, spec, env_idx = data
                shm = shared_memory.SharedMemory(name=name)
                views = _attach_views(shm, spec, env_idx)
                remote.send(True)
            elif cmd == "is_success":
                remote.send(env.is_success())
            elif cmd == "render":
                remote.send(env.render(**data))
            elif cmd == "getattr":
                remote.send(getattr(env, data, None))
            elif cmd == "call":
                name, args, kwargs = data
                remote.send(getattr(env, name)(*args, **kwargs))
            elif cmd == "close":
                views = None
                if shm is not None:
                    shm.close()
                remote.close()
                break
    except (KeyboardInterrupt, EOFError):
        pass


class SubprocVectorEnv:
    """Lockstep pool of env subprocesses; @env_fns are picklable callables
    that each build one env."""

    def __init__(self, env_fns, shared_obs=False):
        ctx = mp.get_context("spawn")
        self.n = len(env_fns)
        self.remotes, work_remotes = zip(*[ctx.Pipe() for _ in range(self.n)])
        self.procs = []
        for remote, work_remote, fn in zip(self.remotes, work_remotes, env_fns):
            p = ctx.Process(target=_worker, args=(work_remote, remote, fn), daemon=True)
            p.start()
            work_remote.close()
            self.procs.append(p)
        self._closed = False
        self._shared_obs = bool(shared_obs)
        self._shm = None
        self._batch = None  # {key: np.ndarray [n, *shape]} over self._shm

    def __len__(self):
        return self.n

    def _send_all(self, cmd, datas=None):
        if datas is None:
            datas = [None] * self.n
        for remote, data in zip(self.remotes, datas):
            remote.send((cmd, data))
        return [remote.recv() for remote in self.remotes]

    # ---------------------------------------------------------- shared obs
    @property
    def shm_name(self):
        """The shared-memory segment's name (None before the first reset)."""
        return None if self._shm is None else self._shm.name

    def _setup_shm(self, first_obs_list):
        """Lay out one block as a batched array per observation key (probed
        from the first reset, which came through the pipes) and attach the
        workers."""
        spec = {}
        offset = 0
        for k, v in first_obs_list[0].items():
            v = np.asarray(v)
            spec[k] = (offset, v.shape, v.dtype.str)
            offset += int(np.prod(v.shape)) * v.itemsize * self.n
        self._shm = shared_memory.SharedMemory(create=True, size=max(offset, 1))
        self._batch = {
            k: np.ndarray((self.n,) + tuple(shape), dtype=dtype,
                          buffer=self._shm.buf, offset=off)
            for k, (off, shape, dtype) in spec.items()
        }
        for i, obs in enumerate(first_obs_list):
            for k, v in obs.items():
                np.copyto(self._batch[k][i], v)
        for i, remote in enumerate(self.remotes):
            remote.send(("attach_shm", (self._shm.name, spec, i)))
        for remote in self.remotes:
            if remote.recv() is not True:
                raise RuntimeError("a worker failed to attach the shared block")

    def _obs_copies(self, ids=None):
        """Per-env copies of the batched block's rows: the per-env API's
        observations outlive the next step."""
        ids = range(self.n) if ids is None else ids
        return [{k: self._batch[k][i].copy() for k in self._batch} for i in ids]

    # -------------------------------------------------------------- control
    def reset(self, ids=None):
        """Per-env observations (copies) of all envs, or of the envs @ids."""
        if ids is None:
            results = self._send_all("reset")
            if self._shared_obs and self._shm is None:
                self._setup_shm(results)
        else:
            for i in ids:
                self.remotes[i].send(("reset", None))
            results = [self.remotes[i].recv() for i in ids]
        if self._shm is not None:
            return self._obs_copies(ids)
        return results

    def reset_to(self, states):
        results = self._send_all("reset_to", states)
        if self._shm is not None:
            return self._obs_copies()
        return results

    def step(self, actions):
        """actions: [N, A] -> (per-env observations (copies), rewards [N],
        dones [N], infos)."""
        obs, rews, dones, infos = self._step(actions)
        if self._shm is not None:
            obs = self._obs_copies()
        return list(obs), rews, dones, infos

    def _step(self, actions):
        """Step every env: (per-env observations, or the shared block's
        placeholders, rewards, dones, infos)."""
        obs, rews, dones, infos = zip(*self._send_all("step", list(np.asarray(actions))))
        return obs, np.asarray(rews), np.asarray(dones), list(infos)

    def step_batched(self, actions):
        """Like :meth:`step`, with the observations as one batched dict: with
        shared_obs the shared block itself (no copy; valid until the next
        call of the pool, so consume it first)."""
        obs, rews, dones, infos = self._step(actions)
        if self._shm is not None:
            obs_batch = self._batch
        else:
            obs_batch = {k: np.stack([np.asarray(o[k]) for o in obs]) for k in obs[0]}
        return obs_batch, rews, dones, infos

    def reset_batched(self):
        """Batched-dict variant of :meth:`reset` (see step_batched)."""
        results = self._send_all("reset")
        if self._shared_obs and self._shm is None:
            self._setup_shm(results)
        if self._shm is not None:
            return self._batch
        return {k: np.stack([np.asarray(o[k]) for o in results]) for k in results[0]}

    def is_success(self):
        return self._send_all("is_success")

    def render(self, **kwargs):
        return self._send_all("render", [kwargs] * self.n)

    def get_env_attr(self, name):
        return self._send_all("getattr", [name] * self.n)

    def call(self, name, *args, **kwargs):
        return self._send_all("call", [(name, args, kwargs)] * self.n)

    def close(self):
        """Stop the workers, then unlink the shared block."""
        if self._closed:
            return
        self._closed = True
        for remote in self.remotes:
            try:
                remote.send(("close", None))
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for remote in self.remotes:
            remote.close()
        if self._shm is not None:
            self._batch = None
            # unlink first: a batch the caller still holds keeps the mapping
            # (close() then refuses), never the name
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
            try:
                self._shm.close()
            except BufferError:
                pass
            self._shm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if hasattr(self, "_closed"):
            self.close()
