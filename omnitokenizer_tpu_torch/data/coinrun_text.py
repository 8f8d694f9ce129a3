"""Auto-captions of CoinRun clips (mirror of
`omnitokenizer_tpu.data.coinrun_text`; the reference's
coinrun/generate_text_desc.py): one sentence from the frame states'
changes over a window: movement, jumps, ladders, coins, power-ups,
monster kills, death.
"""

from __future__ import annotations

from typing import List

from .coinrun import Game


def describe_clip(game: Game, f_start: int = 0, f_end: int = -1,
                  agent_name: str = "Mugen") -> str:
    """What the agent does in frames [f_start, f_end) (to the end when
    f_end <= 0), as '<agent_name> <events>.'."""
    frames = game.frames[f_start:f_end if f_end > 0 else len(game.frames)]
    if not frames:
        return f"{agent_name} stands still."

    events: List[str] = []
    coins = 0
    died = powered = jumped = climbed = False
    prev_eaten = len(frames[0].coins_eaten)
    for fr in frames:
        a = fr.agent
        if a is None:
            continue
        jumped |= a.pose == "jump"
        climbed |= a.pose.startswith("climb")
        died |= bool(a.is_killed)
        powered |= bool(a.power_up_mode)
        new_eaten = len(fr.coins_eaten)
        if new_eaten > prev_eaten:
            coins += new_eaten - prev_eaten
        prev_eaten = new_eaten

    first, last = frames[0].agent, frames[-1].agent
    dx = (last.x - first.x) if (first and last) else 0.0
    if dx > 0.5:
        events.append("runs to the right")
    elif dx < -0.5:
        events.append("runs to the left")
    else:
        events.append("stays in place")
    if jumped:
        events.append("jumps")
    if climbed:
        events.append("climbs a ladder")
    if coins:
        events.append(f"collects {'a coin' if coins == 1 else f'{coins} coins'}")
    if powered:
        events.append("is in power-up mode")
    if any(m.is_dead for fr in frames for m in fr.monsters):
        events.append("kills a monster")
    if died:
        events.append("gets killed")

    body = events[0] if len(events) == 1 else ", ".join(events[:-1]) + " and " + events[-1]
    return f"{agent_name} {body}."
