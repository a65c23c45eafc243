"""Offline-RL proxy dataset (paper Table 3), copied from
``repro.data.rl_proxy`` (numpy only; the same seeds give the same arrays
bit for bit).

D4RL MuJoCo data is not available offline, so this builds a stand-in
that exercises the same system: a 2-D point-mass reach task, behaviour
datasets of three qualities (random / medium / expert, mirroring M, M-R,
M-E), returns-to-go conditioning, and expert-normalised scoring.  Scores
are NOT comparable to D4RL numbers and are labelled as proxy everywhere.

Env: state (pos, vel) in R^2 each, action = accel in [-1, 1]^2,
reward = -||pos - goal||^2 per step, horizon H.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

H = 64                 # episode length
STATE_DIM = 4          # pos(2) + vel(2)
ACT_DIM = 2
DT = 0.1
GOAL = np.array([1.0, -0.5])


def _step(pos, vel, act):
    vel = 0.9 * vel + DT * np.clip(act, -1, 1)
    pos = pos + DT * vel
    reward = -float(((pos - GOAL) ** 2).sum())
    return pos, vel, reward


def _pd_policy(pos, vel, noise, rng):
    act = 2.5 * (GOAL - pos) - 1.2 * vel
    return np.clip(act + noise * rng.standard_normal(2), -1, 1)


def rollout(policy_noise: float, rng: np.random.Generator
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    pos = rng.uniform(-1, 1, 2)
    vel = np.zeros(2)
    states, acts, rews = [], [], []
    for _ in range(H):
        s = np.concatenate([pos, vel])
        if policy_noise >= 10:                       # random policy
            a = rng.uniform(-1, 1, 2)
        else:
            a = _pd_policy(pos, vel, policy_noise, rng)
        pos, vel, r = _step(pos, vel, a)
        states.append(s)
        acts.append(a)
        rews.append(r)
    return (np.array(states, np.float32), np.array(acts, np.float32),
            np.array(rews, np.float32))


DATASETS = {          # mirrors D4RL M / M-R / M-E quality tiers
    "medium": [0.6],
    "medium-replay": [10.0, 0.6],
    "medium-expert": [0.6, 0.05],
}


def build_dataset(name: str, n_episodes: int = 256, seed: int = 0):
    rng = np.random.default_rng(seed)
    noises = DATASETS[name]
    states = np.zeros((n_episodes, H, STATE_DIM), np.float32)
    acts = np.zeros((n_episodes, H, ACT_DIM), np.float32)
    rtg = np.zeros((n_episodes, H, 1), np.float32)
    for e in range(n_episodes):
        s, a, r = rollout(noises[e % len(noises)], rng)
        states[e], acts[e] = s, a
        rtg[e, :, 0] = np.cumsum(r[::-1])[::-1]      # returns-to-go
    return {"states": states, "actions": acts, "rtg": rtg}


def rl_batch(dataset, seed: int, step: int, batch: int) -> Dict:
    rng = np.random.default_rng(np.random.PCG64(seed * 31_337 + step))
    idx = rng.integers(0, len(dataset["states"]), size=batch)
    return {k: v[idx] for k, v in dataset.items()}


def expert_score(seed: int = 1, episodes: int = 16) -> float:
    rng = np.random.default_rng(seed)
    return float(np.mean([rollout(0.05, rng)[2].sum()
                          for _ in range(episodes)]))


def random_score(seed: int = 2, episodes: int = 16) -> float:
    rng = np.random.default_rng(seed)
    return float(np.mean([rollout(10.0, rng)[2].sum()
                          for _ in range(episodes)]))


def normalized(score: float, rand: float, expert: float) -> float:
    """D4RL-style: 100 * (score - random) / (expert - random)."""
    return 100.0 * (score - rand) / max(expert - rand, 1e-6)


def evaluate_policy(act_fn, episodes: int = 16, seed: int = 3,
                    target_rtg: float = 0.0) -> float:
    """Roll out a trained DT-style model: act_fn(states, actions, rtg, t)
    -> action for the current step."""
    rng = np.random.default_rng(seed)
    totals = []
    for _ in range(episodes):
        pos = rng.uniform(-1, 1, 2)
        vel = np.zeros(2)
        states = np.zeros((1, H, STATE_DIM), np.float32)
        acts = np.zeros((1, H, ACT_DIM), np.float32)
        rtg = np.zeros((1, H, 1), np.float32)
        rtg[0, 0, 0] = target_rtg
        total = 0.0
        for t in range(H):
            states[0, t] = np.concatenate([pos, vel])
            a = np.asarray(act_fn(states, acts, rtg, t))
            acts[0, t] = a
            pos, vel, r = _step(pos, vel, a)
            total += r
            if t + 1 < H:
                rtg[0, t + 1, 0] = rtg[0, t, 0] - r
        totals.append(total)
    return float(np.mean(totals))
