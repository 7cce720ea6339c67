"""Scene schema: SoA pytrees replacing the reference's object graph.

The reference stores scenes as vectors of structs with virtual materials
(reference: source/DataTypes.h, source/Scene.h, source/Material.h).  The
array-native design inverts that: a scene is a frozen pytree of flat float32
arrays with static shapes — spheres/planes/triangles as structure-of-arrays,
materials as a parameter *table* indexed by id (no vtable), meshes as a shared
vertex pool + per-mesh transforms so per-frame animation is one batched matmul.

Everything here is jit-compatible; scenes are data, not subclasses.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from raytpu.core import math3d


class CullMode(enum.IntEnum):
    """Triangle cull modes; values match the reference enum order
    (reference: source/DataTypes.h:29-34)."""

    FRONT_FACE = 0
    BACK_FACE = 1
    NONE = 2


class LightKind(enum.IntEnum):
    POINT = 0
    DIRECTIONAL = 1


class MaterialKind(enum.IntEnum):
    """Material families (reference: source/Material.h:34,54,74,99)."""

    SOLID = 0
    LAMBERT = 1
    LAMBERT_PHONG = 2
    COOK_TORRANCE = 3


class LightingMode(enum.IntEnum):
    """Debug lighting modes; order matches the reference enum
    (reference: source/Renderer.h:40-48)."""

    OBSERVED_AREA = 0
    RADIANCE = 1
    BRDF = 2
    COMBINED = 3


def _pytree(cls):
    """Register a dataclass as a JAX pytree (all fields are children)."""
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


def _f32(x):
    return jnp.asarray(x, jnp.float32)


def _i32(x):
    return jnp.asarray(x, jnp.int32)


@_pytree
@dataclass(frozen=True)
class Camera:
    """Pinhole camera.  ``fov_scale`` stores ``tan(fov_angle/2)`` exactly like
    the reference's ``Camera::fov`` (reference: source/Camera.h:55-59)."""

    origin: jnp.ndarray  # (3,)
    forward: jnp.ndarray  # (3,)
    fov_scale: jnp.ndarray  # ()

    @staticmethod
    def create(origin=(0.0, 0.0, 0.0), forward=math3d.UNIT_Z, fov_degrees=90.0):
        fov_degrees = float(np.clip(fov_degrees, 10.0, 175.0))
        fov_scale = np.float32(np.tan(np.float32(fov_degrees) * np.float32(math3d.TO_RADIANS) / 2.0))
        return Camera(_f32(origin), _f32(forward), _f32(fov_scale))

    def with_fov(self, fov_degrees: float) -> "Camera":
        fov_degrees = float(np.clip(fov_degrees, 10.0, 175.0))
        return dataclasses.replace(
            self, fov_scale=_f32(np.tan(np.float32(fov_degrees) * np.float32(math3d.TO_RADIANS) / 2.0))
        )

    def with_orientation(self, pitch, yaw) -> "Camera":
        """Forward from pitch/yaw, ``Rx@Ry`` row-vector order
        (reference: source/Camera.h:61-66)."""
        rot = math3d.mat_rotation(_f32(pitch), _f32(yaw), _f32(0.0))
        return dataclasses.replace(self, forward=math3d.transform_vector(rot, _f32(math3d.UNIT_Z)))

    def onb(self):
        """Camera-to-world orthonormal basis: ``right = normalize(UnitY x fwd)``,
        ``up = normalize(fwd x right)`` (reference: source/Camera.h:43-53)."""
        right = math3d.normalize(jnp.cross(_f32(math3d.UNIT_Y), self.forward))
        up = math3d.normalize(jnp.cross(self.forward, right))
        return right, up, self.forward


@_pytree
@dataclass(frozen=True)
class Spheres:
    center: jnp.ndarray  # (S,3)
    radius: jnp.ndarray  # (S,)
    material: jnp.ndarray  # (S,) i32

    @property
    def count(self):
        return self.center.shape[0]


@_pytree
@dataclass(frozen=True)
class Planes:
    origin: jnp.ndarray  # (P,3)
    normal: jnp.ndarray  # (P,3)
    material: jnp.ndarray  # (P,) i32

    @property
    def count(self):
        return self.origin.shape[0]


@_pytree
@dataclass(frozen=True)
class Triangles:
    """World-space triangle soup (all meshes flattened)."""

    v0: jnp.ndarray  # (T,3)
    v1: jnp.ndarray  # (T,3)
    v2: jnp.ndarray  # (T,3)
    normal: jnp.ndarray  # (T,3) unit face normals
    cull: jnp.ndarray  # (T,) i32 CullMode
    material: jnp.ndarray  # (T,) i32

    @property
    def count(self):
        return self.v0.shape[0]


@_pytree
@dataclass(frozen=True)
class Meshes:
    """Object-space mesh pool + per-mesh transforms.

    Replaces ``TriangleMesh::UpdateTransforms`` (reference: source/DataTypes.h:210-236):
    world-space triangles are recomputed each frame as one batched
    ``p @ (S·R·T)`` over the shared vertex pool.
    """

    positions: jnp.ndarray  # (V,3) object space vertex pool
    face_vertex: jnp.ndarray  # (T,3) i32 indices into positions
    face_normal: jnp.ndarray  # (T,3) object-space unit face normals
    face_mesh: jnp.ndarray  # (T,) i32 mesh id per face
    vertex_mesh: jnp.ndarray  # (V,) i32 mesh id per vertex
    cull: jnp.ndarray  # (N,) i32 per-mesh cull mode
    material: jnp.ndarray  # (N,) i32 per-mesh material id
    scale: jnp.ndarray  # (N,3)
    rotation: jnp.ndarray  # (N,3,3) row-vector rotation
    translation: jnp.ndarray  # (N,3)

    @property
    def num_meshes(self):
        return self.cull.shape[0]

    @property
    def num_faces(self):
        return self.face_vertex.shape[0]

    def with_rotation_y(self, yaw) -> "Meshes":
        """Set every mesh's rotation to RotateY(yaw).  ``yaw`` is scalar or (N,).
        (reference: source/DataTypes.h:162-165)."""
        yaw = jnp.broadcast_to(_f32(yaw), (self.num_meshes,))
        c, s = jnp.cos(yaw), jnp.sin(yaw)
        z = jnp.zeros_like(c)
        o = jnp.ones_like(c)
        rot = jnp.stack(
            [
                jnp.stack([c, z, -s], axis=-1),
                jnp.stack([z, o, z], axis=-1),
                jnp.stack([s, z, c], axis=-1),
            ],
            axis=-2,
        )
        return dataclasses.replace(self, rotation=rot)

    def with_positions(self, positions) -> "Meshes":
        """Replace the vertex pool and recompute object-space per-face normals
        (``normalize(cross(v1-v0, v2-v0))``, reference: source/DataTypes.h:191-208).
        Needed when vertices are optimized (inverse rendering)."""
        v = positions[self.face_vertex]
        n = math3d.normalize_safe(jnp.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]))
        return dataclasses.replace(self, positions=positions, face_normal=n)

    def world_triangles(self) -> Triangles:
        """Batched equivalent of UpdateTransforms: positions through ``S·R·T``
        (scale, then rotate, then translate — row-vector order), face normals
        through the 3x3 part then re-normalized
        (reference: source/DataTypes.h:210-236)."""
        lin = self.scale[:, :, None] * self.rotation  # (N,3,3) == diag(s) @ R
        p_lin = lin[self.vertex_mesh]  # (V,3,3)
        wpos = jnp.einsum("vi,vij->vj", self.positions, p_lin,
                          precision=math3d.HIGHEST) + self.translation[self.vertex_mesh]
        n_lin = lin[self.face_mesh]  # (T,3,3)
        wnrm = math3d.normalize(jnp.einsum("ti,tij->tj", self.face_normal, n_lin,
                                           precision=math3d.HIGHEST))
        v = wpos[self.face_vertex]  # (T,3,3)
        return Triangles(
            v0=v[:, 0],
            v1=v[:, 1],
            v2=v[:, 2],
            normal=wnrm,
            cull=self.cull[self.face_mesh],
            material=self.material[self.face_mesh],
        )

    @staticmethod
    def empty() -> "Meshes":
        return Meshes(
            positions=jnp.zeros((0, 3), jnp.float32),
            face_vertex=jnp.zeros((0, 3), jnp.int32),
            face_normal=jnp.zeros((0, 3), jnp.float32),
            face_mesh=jnp.zeros((0,), jnp.int32),
            vertex_mesh=jnp.zeros((0,), jnp.int32),
            cull=jnp.zeros((0,), jnp.int32),
            material=jnp.zeros((0,), jnp.int32),
            scale=jnp.zeros((0, 3), jnp.float32),
            rotation=jnp.zeros((0, 3, 3), jnp.float32),
            translation=jnp.zeros((0, 3), jnp.float32),
        )


@_pytree
@dataclass(frozen=True)
class Lights:
    position: jnp.ndarray  # (L,3)
    direction: jnp.ndarray  # (L,3)
    color: jnp.ndarray  # (L,3)
    intensity: jnp.ndarray  # (L,)
    kind: jnp.ndarray  # (L,) i32 LightKind

    @property
    def count(self):
        return self.position.shape[0]


@_pytree
@dataclass(frozen=True)
class Materials:
    """Material parameter table; shading dispatches on ``kind`` with masked
    selects instead of virtual calls (reference: source/Material.h:27).

    params layout by kind:
      SOLID:          unused
      LAMBERT:        [kd, -, -]
      LAMBERT_PHONG:  [kd, ks, phong_exponent]
      COOK_TORRANCE:  [metalness, roughness, -]
    ``color`` holds the solid color / diffuse color / albedo respectively.
    """

    kind: jnp.ndarray  # (M,) i32
    color: jnp.ndarray  # (M,3)
    params: jnp.ndarray  # (M,3)

    @property
    def count(self):
        return self.kind.shape[0]


@_pytree
@dataclass(frozen=True)
class Scene:
    """A complete scene: geometry + lights + materials + camera.

    ``triangles`` caches the world-space soup for the current mesh transforms;
    call ``update(total_time)`` (or ``with_meshes``) to animate.
    """

    spheres: Spheres
    planes: Planes
    meshes: Meshes
    triangles: Triangles
    lights: Lights
    materials: Materials
    camera: Camera

    def with_meshes(self, meshes: Meshes) -> "Scene":
        return dataclasses.replace(self, meshes=meshes, triangles=meshes.world_triangles())

    def with_mesh_yaw(self, yaw) -> "Scene":
        return self.with_meshes(self.meshes.with_rotation_y(yaw))

    def with_camera(self, camera: Camera) -> "Scene":
        return dataclasses.replace(self, camera=camera)

    def update(self, total_time) -> "Scene":
        """Default per-frame animation of the course scenes: every mesh yaws by
        ``(cos(t)+1)/2 * 2π`` (reference: source/Scene.cpp:394)."""
        if self.meshes.num_meshes == 0:
            return self
        yaw = (jnp.cos(_f32(total_time)) + 1.0) / 2.0 * np.float32(math3d.PI_2)
        return self.with_mesh_yaw(yaw)

    @property
    def num_primitives(self):
        return self.spheres.count + self.planes.count + self.triangles.count


@dataclass(frozen=True)
class RenderConfig:
    """Static render settings — the framework's flag system, replacing the
    reference's compile-time #defines and F-key toggles
    (reference: source/Renderer.cpp:21-22, source/main.cpp:70-81).

    Hashable: pass as a static argument to jit.
    """

    width: int = 640
    height: int = 480
    lighting_mode: LightingMode = LightingMode.COMBINED
    shadows: bool = True
    shadow_dim: float = 0.95  # per-occluded-light pixel dimming factor
    ray_min: float = 1e-4
    normal_offset: float = 1e-4
    soft_shadows: bool = False  # differentiable visibility (grad path)
    soft_beta: float = 300.0  # sharpness of the soft visibility sigmoid
    ray_chunk: Optional[int] = None  # rays per lax.map chunk (None = auto)

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height


# ---------------------------------------------------------------------------
# Builder — the mutable, host-side mirror of Scene::Add* helpers
# (reference: source/Scene.cpp:99-159).
# ---------------------------------------------------------------------------


@dataclass
class _MeshAccum:
    cull: int
    material: int
    positions: list = field(default_factory=list)
    indices: list = field(default_factory=list)  # flat, 3 per face
    normals: list = field(default_factory=list)  # per-face, optional
    scale: tuple = (1.0, 1.0, 1.0)
    yaw: float = 0.0
    translation: tuple = (0.0, 0.0, 0.0)


class MeshHandle:
    """Handle returned by ``SceneBuilder.add_triangle_mesh``; mirrors the
    TriangleMesh mutators (reference: source/DataTypes.h:157-189)."""

    def __init__(self, accum: _MeshAccum):
        self._a = accum

    def append_triangle(self, v0, v1, v2, normal=None):
        a = self._a
        base = len(a.positions)
        a.positions += [tuple(v0), tuple(v1), tuple(v2)]
        a.indices += [base, base + 1, base + 2]
        if normal is None:
            e1 = np.asarray(v1, np.float32) - np.asarray(v0, np.float32)
            e2 = np.asarray(v2, np.float32) - np.asarray(v0, np.float32)
            n = np.cross(e1, e2)
            n = n / np.linalg.norm(n)
            normal = tuple(n.tolist())
        a.normals.append(tuple(normal))
        return self

    def set_geometry(self, positions, indices, normals=None):
        """Bulk-load vertex/index data (e.g. from the OBJ parser)."""
        a = self._a
        a.positions = [tuple(p) for p in positions]
        a.indices = [int(i) for i in indices]
        if normals is not None:
            a.normals = [tuple(n) for n in normals]
        else:
            a.normals = []
        return self

    def scale(self, s):
        self._a.scale = tuple(float(x) for x in s)
        return self

    def rotate_y(self, yaw):
        self._a.yaw = float(yaw)
        return self

    def translate(self, t):
        self._a.translation = tuple(float(x) for x in t)
        return self


class SceneBuilder:
    """Host-side scene assembly producing a frozen Scene pytree.

    Starts with material 0 = solid red, like the reference Scene constructor
    (reference: source/Scene.cpp:9-16).
    """

    def __init__(self, default_material: bool = True):
        self._mat_kind, self._mat_color, self._mat_params = [], [], []
        if default_material:
            self.add_solid_color((1.0, 0.0, 0.0))
        self._sph_c, self._sph_r, self._sph_m = [], [], []
        self._pl_o, self._pl_n, self._pl_m = [], [], []
        self._meshes: list[_MeshAccum] = []
        self._li_p, self._li_d, self._li_c, self._li_i, self._li_k = [], [], [], [], []
        self.camera = Camera.create()

    # -- materials ---------------------------------------------------------
    def _add_material(self, kind, color, params):
        self._mat_kind.append(int(kind))
        self._mat_color.append(tuple(color))
        self._mat_params.append(tuple(params))
        return len(self._mat_kind) - 1

    def add_solid_color(self, color):
        return self._add_material(MaterialKind.SOLID, color, (0.0, 0.0, 0.0))

    def add_lambert(self, diffuse_color, kd):
        return self._add_material(MaterialKind.LAMBERT, diffuse_color, (kd, 0.0, 0.0))

    def add_lambert_phong(self, diffuse_color, kd, ks, phong_exponent):
        return self._add_material(MaterialKind.LAMBERT_PHONG, diffuse_color, (kd, ks, phong_exponent))

    def add_cook_torrance(self, albedo, metalness, roughness):
        return self._add_material(MaterialKind.COOK_TORRANCE, albedo, (metalness, roughness, 0.0))

    # -- geometry ----------------------------------------------------------
    def add_sphere(self, origin, radius, material):
        self._sph_c.append(tuple(origin))
        self._sph_r.append(float(radius))
        self._sph_m.append(int(material))
        return self

    def add_plane(self, origin, normal, material):
        self._pl_o.append(tuple(origin))
        self._pl_n.append(tuple(normal))
        self._pl_m.append(int(material))
        return self

    def add_triangle_mesh(self, cull: CullMode, material: int) -> MeshHandle:
        a = _MeshAccum(cull=int(cull), material=int(material))
        self._meshes.append(a)
        return MeshHandle(a)

    # -- lights ------------------------------------------------------------
    def add_point_light(self, origin, intensity, color):
        self._li_p.append(tuple(origin))
        self._li_d.append((0.0, 0.0, 1.0))
        self._li_c.append(tuple(color))
        self._li_i.append(float(intensity))
        self._li_k.append(int(LightKind.POINT))
        return self

    def add_directional_light(self, direction, intensity, color):
        """Directional light with *correct* direction semantics.  (The
        reference's directional branch is dead code with a latent bug,
        reference: source/Utils.h:348; we implement it properly.)"""
        self._li_p.append((0.0, 0.0, 0.0))
        d = np.asarray(direction, np.float32)
        d = d / np.linalg.norm(d)
        self._li_d.append(tuple(d.tolist()))
        self._li_c.append(tuple(color))
        self._li_i.append(float(intensity))
        self._li_k.append(int(LightKind.DIRECTIONAL))
        return self

    # -- camera ------------------------------------------------------------
    def set_camera(self, origin, fov_degrees=90.0, forward=math3d.UNIT_Z):
        self.camera = Camera.create(origin, forward, fov_degrees)
        return self

    # -- build -------------------------------------------------------------
    def build(self) -> Scene:
        spheres = Spheres(
            center=_f32(np.asarray(self._sph_c, np.float32).reshape(-1, 3)),
            radius=_f32(np.asarray(self._sph_r, np.float32)),
            material=_i32(np.asarray(self._sph_m, np.int32)),
        )
        planes = Planes(
            origin=_f32(np.asarray(self._pl_o, np.float32).reshape(-1, 3)),
            normal=_f32(np.asarray(self._pl_n, np.float32).reshape(-1, 3)),
            material=_i32(np.asarray(self._pl_m, np.int32)),
        )
        meshes = self._build_meshes()
        # spatially order large meshes so the culled sweep's cull groups
        # get tight AABBs (raytpu.ops.accel); small scenes keep
        # insertion order for exact reference tie-break parity
        reorder_large = meshes.num_faces > 256
        lights = Lights(
            position=_f32(np.asarray(self._li_p, np.float32).reshape(-1, 3)),
            direction=_f32(np.asarray(self._li_d, np.float32).reshape(-1, 3)),
            color=_f32(np.asarray(self._li_c, np.float32).reshape(-1, 3)),
            intensity=_f32(np.asarray(self._li_i, np.float32)),
            kind=_i32(np.asarray(self._li_k, np.int32)),
        )
        materials = Materials(
            kind=_i32(np.asarray(self._mat_kind, np.int32)),
            color=_f32(np.asarray(self._mat_color, np.float32).reshape(-1, 3)),
            params=_f32(np.asarray(self._mat_params, np.float32).reshape(-1, 3)),
        )
        scene = Scene(
            spheres=spheres,
            planes=planes,
            meshes=meshes,
            triangles=meshes.world_triangles(),
            lights=lights,
            materials=materials,
            camera=self.camera,
        )
        if reorder_large:
            from raytpu.ops import accel

            scene = accel.reorder_scene_triangles(scene)
        return scene

    def _build_meshes(self) -> Meshes:
        if not self._meshes:
            return Meshes.empty()
        positions, face_vertex, face_normal = [], [], []
        face_mesh, vertex_mesh = [], []
        cull, material, scale, yaw, translation = [], [], [], [], []
        v_base = 0
        for mid, a in enumerate(self._meshes):
            pos = np.asarray(a.positions, np.float32).reshape(-1, 3)
            idx = np.asarray(a.indices, np.int32).reshape(-1, 3)
            if a.normals:
                nrm = np.asarray(a.normals, np.float32).reshape(-1, 3)
            else:
                # per-face normals from cross(e1, e2), normalized
                # (reference: source/DataTypes.h:191-208)
                v = pos[idx]
                n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
                n = n / np.linalg.norm(n, axis=-1, keepdims=True)
                nrm = n.astype(np.float32)
            positions.append(pos)
            face_vertex.append(idx + v_base)
            face_normal.append(nrm)
            face_mesh.append(np.full((idx.shape[0],), mid, np.int32))
            vertex_mesh.append(np.full((pos.shape[0],), mid, np.int32))
            cull.append(a.cull)
            material.append(a.material)
            scale.append(a.scale)
            yaw.append(a.yaw)
            translation.append(a.translation)
            v_base += pos.shape[0]
        n_mesh = len(self._meshes)
        yaw_arr = np.asarray(yaw, np.float32)
        c, s = np.cos(yaw_arr), np.sin(yaw_arr)
        rot = np.zeros((n_mesh, 3, 3), np.float32)
        rot[:, 0, 0] = c
        rot[:, 0, 2] = -s
        rot[:, 1, 1] = 1.0
        rot[:, 2, 0] = s
        rot[:, 2, 2] = c
        return Meshes(
            positions=_f32(np.concatenate(positions, axis=0)),
            face_vertex=_i32(np.concatenate(face_vertex, axis=0)),
            face_normal=_f32(np.concatenate(face_normal, axis=0)),
            face_mesh=_i32(np.concatenate(face_mesh, axis=0)),
            vertex_mesh=_i32(np.concatenate(vertex_mesh, axis=0)),
            cull=_i32(np.asarray(cull, np.int32)),
            material=_i32(np.asarray(material, np.int32)),
            scale=_f32(np.asarray(scale, np.float32).reshape(-1, 3)),
            rotation=_f32(rot),
            translation=_f32(np.asarray(translation, np.float32).reshape(-1, 3)),
        )
