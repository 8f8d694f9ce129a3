"""CoinRun: game traces in JSON -> rendered frames -> dataset clips (mirror
of `omnitokenizer_tpu.data.coinrun`; the reference's coinrun/game.py,
construct_from_json.py and coinrun_data.py).

    ds = CoinRunDataset("coinrun/train", "coinrun/assets", sequence_length=17,
                        resolution=256, get_text_desc=True)
    sample = ds[0]   # video (17, 256, 256, 3) in [-0.5, 0.5], text (256,) BPE ids

A frame is rendered by numpy alpha compositing (`_blit`) of the sprites
of `asset_paths` (the kenney sprite sheets under `asset_root`, which the
user supplies), with the reference's camera; the frames are bit-equal to
the JAX package's renderer.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

import numpy as np

# maze symbols (construct_from_json.py:17-31)
SPACE, LADDER = ".", "="
LAVA_SURFACE, LAVA_MIDDLE = "^", "|"
WALL_SURFACE, WALL_MIDDLE = "S", "A"
WALL_CLIFF_LEFT, WALL_CLIFF_RIGHT = "a", "b"
COIN1, COIN2 = "1", "2"
CRATES = "#$&%"

DEATH_ANIM_LENGTH = 30
MONSTER_DEATH_ANIM_LENGTH = 3

_ZOOM_DY_RATIO = {5.5: 5.0, 4.3: 6.5, 5.0: 5.5, 6.0: 4.5}


# -- the game state (game.py) -------------------------------------------------
class Agent:
    def __init__(self, x, y, vx=0.0, vy=0.0, time_alive=0, ladder=False,
                 spring=0, is_killed=False, killed_animation_frame_cnt=0,
                 power_up_mode=False, **kw):
        self.x, self.y, self.vx, self.vy = x, y, vx, vy
        self.time_alive = time_alive
        self.ladder = ladder
        self.spring = spring
        self.is_killed = is_killed
        self.killed_animation_frame_cnt = killed_animation_frame_cnt
        self.power_up_mode = power_up_mode
        self.is_facing_right = vx >= 0
        self.walk1_mode = (time_alive // 5) % 2 == 0
        self.pose = self._pose()

    def _pose(self) -> str:
        if self.is_killed:
            return "hit"
        if self.ladder:
            return "climb1" if self.walk1_mode else "climb2"
        if self.vy != 0:
            return "jump"
        if self.spring != 0:
            return "duck"
        if self.vx == 0:
            return "stand"
        return "walk1" if self.walk1_mode else "walk2"


class Monster:
    def __init__(self, m_id, x, y, vx=0.0, vy=0.0, theme=0, is_jumping=False,
                 is_dead=False, time=0, anim_freq=1, monster_dying_frame_cnt=0, **kw):
        self.m_id, self.x, self.y, self.vx, self.vy = m_id, x, y, vx, vy
        self.theme = theme
        self.is_dead = is_dead
        self.monster_dying_frame_cnt = monster_dying_frame_cnt
        if is_jumping:
            self.walk1_mode = vy == 0
        else:
            self.walk1_mode = (time // max(anim_freq, 1)) % 2 == 0


class Frame:
    def __init__(self, frame_id=-1, file_name="", state_time=0, coins_eaten=None, agent=None,
                 monsters=None, **kw):
        self.frame_id = frame_id
        self.file_name = file_name
        self.state_time = state_time
        self.coins_eaten = coins_eaten or []
        self.agent = Agent(**agent) if agent else None
        self.monsters = [Monster(**m) for m in (monsters or [])]


class Game:
    def __init__(self, **kw):
        self.zoom = 5.5
        self.bgzoom = 0.4
        self.video_res = 1024
        self.maze_w, self.maze_h = 64, 13
        self.world_theme_n = -1
        self.agent_theme_n = -1
        self.background_themes: List[str] = []
        self.ground_themes: List[str] = []
        self.agent_themes: List[str] = []
        self.monster_names: Dict[str, List[str]] = {}
        self.maze = None
        self.frames: List[Frame] = []
        self.__dict__.update(kw)
        self.frames = [f if isinstance(f, Frame) else Frame(**f) for f in self.frames]
        self.flattened_monster_names: List[str] = []
        if self.monster_names:
            mn = self.monster_names
            self.flattened_monster_names = (list(mn.get("ground", [])) + list(mn.get("walking", []))
                                            + list(mn.get("flying", [])))

    @classmethod
    def from_json(cls, path: str) -> "Game":
        with open(path) as f:
            g = cls(**json.load(f))
        g._reset_eaten_coins()
        return g

    def _reset_eaten_coins(self):
        """Put back the coins eaten within the trace (game.py:92-99)."""
        if not self.frames or self.maze is None:
            return
        for cx, cy in self.frames[-1].coins_eaten:
            if self.maze[cy][cx] == SPACE:
                self.maze[cy] = self.maze[cy][:cx] + COIN1 + self.maze[cy][cx + 1:]


# -- the sprites (numpy RGBA) ---------------------------------------------------
def asset_paths(game: Game) -> Dict[str, object]:
    """The sprite files of a game, relative to the asset root
    (construct_from_json.py:115-208): background, world tiles by maze
    symbol, the alien by pose, the monsters by name."""
    bg = game.background_themes[game.world_theme_n]
    gt = game.ground_themes[game.world_theme_n]
    walls = f"kenney/Ground/{gt}/{gt.lower()}"
    at = game.agent_themes[game.agent_theme_n]
    alien = f"kenneyLarge/Players/128x256_no_helmet/{at}/alien{at}"
    tiles, items, enemy = "kenney/Tiles/", "kenneyLarge/Items/", "kenneyLarge/Enemies/"
    world = {
        WALL_MIDDLE: walls + "Center.png", WALL_SURFACE: walls + "Mid.png",
        WALL_CLIFF_LEFT: walls + "Cliff_left.png",
        WALL_CLIFF_RIGHT: walls + "Cliff_right.png",
        COIN1: items + "coinGold.png", COIN2: items + "gemRed.png",
        "#": tiles + "boxCrate.png", "$": tiles + "boxCrate_double.png",
        "&": tiles + "boxCrate_single.png", "%": tiles + "boxCrate_warning.png",
        LAVA_MIDDLE: tiles + "lava.png", LAVA_SURFACE: tiles + "lavaTop_low.png",
        LADDER: tiles + "ladderMid.png",
    }
    poses = ["walk1", "walk2", "climb1", "climb2", "stand", "jump", "duck", "hit"]
    return dict(background=bg, world=world,
                alien={p: f"{alien}_{p}.png" for p in poses},
                monster={n: enemy + n + ".png" for n in game.flattened_monster_names})


class AssetBank:
    """A game's sprites, loaded and resized once, as numpy RGBA arrays; the
    background opaque RGBA at the zoomed size."""

    def __init__(self, game: Game, asset_root: str, kx: float, ky: float):
        from PIL import Image

        self.root = asset_root
        self.kx, self.ky = kx, ky
        self.sprites: Dict[str, np.ndarray] = {}
        paths = asset_paths(game)

        def load(rel, size):
            p = os.path.join(asset_root, rel)
            if not os.path.isfile(p):  # a pose's sprite missing: the one without the suffix
                base, ext = os.path.splitext(p)
                p = "_".join(base.split("_")[:-1]) + ext
            return np.asarray(Image.open(p).convert("RGBA").resize(size), np.uint8)

        for key, rel in paths["world"].items():
            self.sprites[key] = load(rel, (math.ceil(kx + 0.5), math.ceil(ky + 0.5)))
        for pose, rel in paths["alien"].items():
            spr = load(rel, (math.ceil(kx), math.ceil(2 * ky)))
            self.sprites[f"alien_{pose}"] = spr
            self.sprites[f"alien_{pose}_left"] = spr[:, ::-1]
        for name, rel in paths["monster"].items():
            for pose in ("", "_move", "_dead"):
                base, ext = os.path.splitext(rel)
                spr = load(base + pose + ext, (math.ceil(kx), math.ceil(ky)))
                self.sprites[name + pose] = spr
                self.sprites[name + pose + "_right"] = spr[:, ::-1]
        bgsize = math.ceil(game.video_res * game.zoom)
        self.background = load(paths["background"], (bgsize, bgsize))[..., :3]
        # the background as drawn: opaque RGBA, built once (not once a tile)
        self.background_rgba = np.dstack([self.background,
                                          np.full(self.background.shape[:2], 255, np.uint8)])


def _blit(canvas: np.ndarray, sprite: np.ndarray, x: int, y: int,
          w: Optional[int] = None, h: Optional[int] = None):
    """Alpha-composite `sprite` onto `canvas` at (x, y), clipped to the
    canvas; resized first (nearest) to (w, h) when given."""
    if w is not None and (sprite.shape[1] != w or sprite.shape[0] != h):
        from PIL import Image

        if w <= 0 or h <= 0:
            return
        sprite = np.asarray(Image.fromarray(sprite).resize((w, h), Image.NEAREST), np.uint8)
    sh, sw = sprite.shape[:2]
    H, W = canvas.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + sw, W), min(y + sh, H)
    if x1 <= x0 or y1 <= y0:
        return
    tile = sprite[y0 - y:y1 - y, x0 - x:x1 - x]
    alpha = tile[..., 3:4].astype(np.float32) / 255.0
    region = canvas[y0:y1, x0:x1]
    canvas[y0:y1, x0:x1] = (tile[..., :3].astype(np.float32) * alpha
                            + region.astype(np.float32) * (1 - alpha)).astype(np.uint8)


def draw_game_frame(game: Game, frame_id: int, bank: AssetBank, kx: float, ky: float
                    ) -> np.ndarray:
    """One (video_res, video_res, 3) uint8 frame: the gen_original=True path
    of construct_from_json.py:461-696 with its camera (the agent centred,
    the background's parallax), the tiles near the agent, the monsters,
    then the agent (fading while it dies)."""
    res = game.video_res
    canvas = np.zeros((res, res, 3), np.uint8)
    center = (res - 1) // 2
    fr = game.frames[frame_id]

    dx = -fr.agent.x * kx + center - 0.5 * kx
    dy = -center + _ZOOM_DY_RATIO[game.zoom] * ky

    zx = res * game.zoom
    for tx in range(-1, 3):
        for ty in range(-1, 2):
            bx = zx * tx + center + game.bgzoom * (dx + kx * game.maze_h / 2) - zx * 0.5
            by = zx * ty + center + game.bgzoom * (dy - ky * game.maze_h / 2) - zx * 0.5
            _blit(canvas, bank.background_rgba, int(bx), int(by))

    radius = int(1 + game.maze_w / game.zoom)
    ix, iy = int(fr.agent.x + 0.5), int(fr.agent.y + 0.5)
    eaten = {tuple(c) for c in fr.coins_eaten}
    for y in range(max(iy - radius, 0), min(iy + radius + 1, game.maze_h)):
        for x in range(max(ix - radius, 0), min(ix + radius + 1, game.maze_w)):
            wkey = game.maze[y][x]
            if wkey == SPACE or (x, y) in eaten:
                continue
            _blit(canvas, bank.sprites[wkey], math.floor(kx * x + dx),
                  math.floor(res - ky * y + dy))

    for m in fr.monsters:
        name = game.flattened_monster_names[m.theme]
        pose = "_dead" if m.is_dead else ("" if m.walk1_mode else "_move")
        key = name + pose + ("_right" if m.vx > 0 else "")
        h = math.ceil(ky)
        y_off = 0.0
        if m.is_dead:
            shrink = (MONSTER_DEATH_ANIM_LENGTH - max(0, m.monster_dying_frame_cnt)) \
                * 0.8 / MONSTER_DEATH_ANIM_LENGTH
            h = math.ceil(ky * (1 - shrink))
            y_off = ky * shrink
        _blit(canvas, bank.sprites[key], math.floor(kx * m.x + dx),
              math.floor(res - ky * m.y + dy + y_off), math.ceil(kx), h)

    a = fr.agent
    sprite = bank.sprites[f"alien_{a.pose}" + ("" if a.is_facing_right else "_left")]
    if a.is_killed:
        transparency = (DEATH_ANIM_LENGTH + 1 - a.killed_animation_frame_cnt) * 12
        if transparency > 255:
            sprite = None
        else:
            sprite = sprite.copy()
            sprite[..., 3] = np.clip(sprite[..., 3].astype(np.int16) - transparency,
                                     0, 255).astype(np.uint8)
    if sprite is not None:
        _blit(canvas, sprite, math.floor(kx * a.x + dx), math.floor(res - ky * (a.y + 1) + dy))
    return canvas


# -- the dataset (coinrun_data.py) -------------------------------------------------
class CoinRunDataset:
    """Clips of `sequence_length` frames rendered at `resolution` from the
    game JSONs under `data_folder` (game.py's asdict format): a random
    window of each trace, zero frames after a trace shorter than it;
    channels-last in [-0.5, 0.5], `label` -1 and the JSON's `path`.

    With get_text_desc (the reference's CoinRunDataset(get_text_desc=True),
    coinrun_data.py:103,373-411) each sample adds `text`: the clip's
    caption as int64 BPE ids (data/text_tokenizer.py's `tokenize`,
    text_seq_len wide, cut with eot last when truncate_captions): a manual
    caption from the JSON file `text_path` ({clip id: [captions]}, one drawn
    at random when there are several) where it has the clip, else the
    auto-caption of the window (data/coinrun_text.py). `bpe_path` names the
    BPE merge table (default: the tokenizer's)."""

    def __init__(self, data_folder: str, asset_root: str, sequence_length: int = 17,
                 resolution: int = 256, train: bool = True, seed: int = 1234,
                 get_text_desc: bool = False, text_seq_len: int = 256,
                 truncate_captions: bool = True, text_path: Optional[str] = None,
                 bpe_path: Optional[str] = None):
        self.asset_root = asset_root
        self.sequence_length = sequence_length
        self.resolution = resolution
        self.rng = np.random.RandomState(seed)
        self.files = sorted(os.path.join(r, n) for r, _, fs in os.walk(data_folder)
                            for n in fs if n.endswith(".json"))
        self._banks: Dict[str, AssetBank] = {}
        self.get_text_desc = get_text_desc
        self.text_seq_len = text_seq_len
        self.truncate_captions = truncate_captions
        self.text_data = None
        self._tokenizer = None
        if get_text_desc:
            from .text_tokenizer import SimpleTokenizer

            self._tokenizer = SimpleTokenizer(bpe_path)
            if text_path:
                with open(text_path) as f:
                    self.text_data = json.load(f)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int):
        game = Game.from_json(self.files[idx])
        game.video_res = self.resolution
        kx = game.zoom * self.resolution / game.maze_w
        ky = kx
        bank_key = f"{game.world_theme_n}/{game.agent_theme_n}/{self.resolution}"
        if bank_key not in self._banks:
            self._banks[bank_key] = AssetBank(game, self.asset_root, kx, ky)
        bank = self._banks[bank_key]

        n = len(game.frames)
        seq = min(self.sequence_length, n)
        start = self.rng.randint(0, n - seq + 1)
        frames = np.stack([draw_game_frame(game, start + i, bank, kx, ky) for i in range(seq)])
        if seq < self.sequence_length:
            pad = np.zeros((self.sequence_length - seq,) + frames.shape[1:], np.uint8)
            frames = np.concatenate([frames, pad])
        out = {"video": frames.astype(np.float32) / 255.0 - 0.5, "label": -1,
               "path": self.files[idx]}
        if self.get_text_desc:
            key = os.path.splitext(os.path.basename(self.files[idx]))[0]
            if self.text_data is not None and key in self.text_data:
                caps = self.text_data[key]
                cap = caps[0] if len(caps) == 1 else caps[self.rng.randint(len(caps))]
            else:
                from .coinrun_text import describe_clip

                cap = describe_clip(game, start, start + seq)
            out["text"] = np.asarray(
                self._tokenizer.tokenize(cap, self.text_seq_len, self.truncate_captions),
                np.int64)
        return out
