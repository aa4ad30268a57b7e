"""The MPE scenarios (reference ``vmas/scenarios/mpe``)."""
import torch


def select_landmark(landmarks, index):
    """``[B, 2]``: each env's position of landmark ``index[b]`` (the
    per-env goal of simple_adversary, simple_push, simple_reference and
    simple_speaker_listener)."""
    landmark_pos = torch.stack([l.state.pos for l in landmarks], dim=1)
    return torch.gather(
        landmark_pos, 1, index[:, None, None].expand(-1, 1, 2)
    )[:, 0]
