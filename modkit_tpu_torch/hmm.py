"""2-state (Same/Different) Viterbi HMM for DMR segmentation.

Reference equivalent: ``src/hmm.rs``. Emissions come from per-site DMR
scores via ``p_same = exp(-max(score, 0))``; the Different-state stay
probability decays with the genomic gap to the next site (linear or
logarithmic projection toward the DMR prior at ``decay_distance``).

The decode path reproduces the reference's exact backtrace walk
(hmm.rs:194-217), including its quirk of returning ``len(scores) - 1``
states (the state of the second-to-last DP index is skipped).
"""

from __future__ import annotations

import math

import numpy as np

SAME = 0
DIFFERENT = 1
STATE_NAMES = ("same", "different")


class Projection:
    """hmm.rs:348-412 -- gap -> p(diff stays diff)."""

    def __init__(self, decay_distance: int, diff_stay: float, dmr_prior: float):
        if diff_stay <= dmr_prior:
            raise ValueError("max_diff_stay must be > switch_prob")
        self.low = 1.0 - diff_stay
        self.high = 1.0 - dmr_prior
        self.dist_lo = 2.0
        self.dist_hi = float(decay_distance)
        self.prob_span = self.high - self.low
        self.ratio = self.prob_span / (self.dist_hi - self.dist_lo)

    def linear_project_prob(self, x: float) -> float:
        x = min(x, self.dist_hi)
        return 1.0 - ((x - self.dist_lo) * self.ratio + self.low)

    def ln_project_prob(self, x: float) -> float:
        if x == 1.0:
            return 1.0 - self.low
        x = min(x, self.dist_hi)
        ln_ratio = math.log(self.dist_hi) - math.log(self.dist_lo)
        adjusted = (
            (math.log(x) - math.log(self.dist_lo)) / ln_ratio
        ) * self.prob_span + self.low
        return 1.0 - adjusted


class HmmModel:
    """hmm.rs:106-346."""

    def __init__(
        self,
        dmr_prior: float = 0.1,
        diff_stay: float = 0.9,
        same_state_factor: float = 0.3,
        diff_state_factor: float = -0.1,
        significance_factor: float = 0.01,
        decay_distance: int = 500,
        linear_transitions: bool = True,
    ):
        if not (0.0 <= significance_factor < 1.0):
            raise ValueError("fpr must be in [0, 1)")
        self.same_to_diff = math.log(dmr_prior)
        self.same_to_same = math.log(1.0 - dmr_prior)
        self.dmr_prior = dmr_prior
        self.same_state_factor = same_state_factor
        self.diff_state_factor = diff_state_factor
        self.significance_factor = math.log(
            significance_factor / (1.0 - significance_factor)
        )
        self.linear = linear_transitions
        self.projection = Projection(decay_distance, diff_stay, dmr_prior)

    def _emissions(self, p: float) -> tuple[float, float]:
        """(e_same, e_diff) for p_same = p (hmm.rs:256-272)."""
        if p == 0.0:
            p = 1e-5
        e_same = self.same_state_factor * (
            math.log(p) - self.significance_factor
        )
        e_diff = self.diff_state_factor * (
            math.log(1.0 - p + 1e-5) - self.significance_factor
        )
        return e_same, e_diff

    def viterbi_path(self, scores, positions) -> list[int]:
        """hmm.rs:161-217. Returns len(scores) - 1 state labels."""
        probs = [math.exp(-max(s, 0.0)) for s in scores]
        transitions = [self.dmr_prior]
        for prev, nxt in zip(positions, positions[1:]):
            gap = float(nxt - prev)
            if self.linear:
                transitions.append(self.projection.linear_project_prob(gap))
            else:
                transitions.append(self.projection.ln_project_prob(gap))

        n = len(probs)
        # forward DP: dp[i] = best log-prob of state at DP index i
        dp = np.empty((n + 1, 2))
        ptr = np.full((n + 1, 2), -1, dtype=np.int8)
        dp[0, SAME] = self.same_to_same
        dp[0, DIFFERENT] = self.same_to_diff
        for i in range(n):
            p_d2d = transitions[i]
            ln_d2d = math.log(p_d2d)
            ln_d2s = math.log(1.0 - p_d2d)
            e_same, e_diff = self._emissions(probs[i])
            p_same, p_diff = dp[i, SAME], dp[i, DIFFERENT]
            # Same state: max(same->same, diff->same)
            same2same = p_same + self.same_to_same
            diff2same = p_diff + ln_d2s
            if same2same > diff2same:  # Rust max_by keeps the LAST max on ties
                dp[i + 1, SAME] = same2same + e_same
                ptr[i + 1, SAME] = SAME
            else:
                dp[i + 1, SAME] = diff2same + e_same
                ptr[i + 1, SAME] = DIFFERENT
            # Diff state: max(diff->diff, same->diff)
            diff2diff = p_diff + ln_d2d
            same2diff = p_same + self.same_to_diff
            if diff2diff > same2diff:  # ties resolve to the later element
                dp[i + 1, DIFFERENT] = diff2diff + e_diff
                ptr[i + 1, DIFFERENT] = DIFFERENT
            else:
                dp[i + 1, DIFFERENT] = same2diff + e_diff
                ptr[i + 1, DIFFERENT] = SAME

        # reference decode walk (hmm.rs:194-217): the state at DP index
        # n-1 is consumed as the initial pointer but never emitted
        # DpCell::argmax via max_by keeps the last max on ties -> Different
        final_state = DIFFERENT if dp[n, DIFFERENT] >= dp[n, SAME] else SAME
        path = [final_state]
        curr = int(ptr[n, final_state])
        for i in range(n - 1, 0, -1):
            nxt = ptr[i, curr]
            if nxt < 0:
                break
            path.append(int(nxt))
            curr = int(nxt)
        path.pop()
        path.reverse()
        return path


def path_to_region_labels(
    path: list[int], positions: list[int]
) -> list[tuple[int, int, int]]:
    """(start, end, state) runs from a decoded path (single_site.rs:1141-1170).
    path[i] labels positions[i]; the final position extends the last run."""
    assert len(path) == len(positions) - 1
    if not path:
        return []
    curr_state = path[0]
    curr_position = positions[0]
    last_position = curr_position + 1
    out = []
    for state, pos in list(zip(path, positions))[1:]:
        if state != curr_state:
            out.append((curr_position, last_position, curr_state))
            curr_position = pos
            last_position = pos + 1
            curr_state = state
        else:
            last_position = pos + 1
    out.append((curr_position, last_position, curr_state))
    return out
